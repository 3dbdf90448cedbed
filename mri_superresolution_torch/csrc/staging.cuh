// Staging whole images in shared memory, shared by B1's one-pass kernels
// (groupnorm_onepass.cu forward, groupnorm_bwd_onepass.cu backward): 1D bulk
// copies (cp.async.bulk, the TMA; no tensor map) completing on mbarriers,
// the thread layout of a staged channels-last range, and the acquire load
// of the per-image arrival counters.
#pragma once

#include "common.cuh"

namespace msr {

// Both kernels run 512 threads a block and copy in pieces of 32 KB: 4 rows
// of 512 16-byte vectors, so a piece is 4 * rows whole pixels.
constexpr int kStageThreads = 512;
constexpr unsigned kPieceBytes = 4 * kStageThreads * 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Thread 0 starts the copy of one 32 KB piece of a block's range (`bytes`
// long from src) into the stage at dst, completing on mbarrier `bar`.
template <typename T>
__device__ __forceinline__ void stage_piece(const T* src, uint32_t dst,
                                            uint32_t bytes, int piece,
                                            uint32_t bar) {
  const uint32_t off = piece * kPieceBytes;
  const uint32_t n = bytes - off < kPieceBytes ? bytes - off : kPieceBytes;
  mbar_expect(bar, n);
  bulk_load(dst + off, reinterpret_cast<const char*>(src) + off, n, bar);
}

// Launch geometry shared by the kernels and their host checks: vpp vectors
// of V channels a pixel, kStageThreads / vpp pixels walked together; each
// row of partials holds `ent` entries (a vector's folded group sum when the
// vector lies in one group, else one per channel), and the block has
// kStageThreads / max(vpp, 32) such rows.
struct Layout {
  int vpp, rows, cg, ent, per_group, span, prow;
  bool fold;
  __host__ __device__ Layout(int c, int g, int v) {
    vpp = c / v;
    rows = kStageThreads / vpp;
    cg = c / g;
    fold = cg >= v;
    ent = fold ? vpp : c;
    per_group = ent / g;
    span = vpp > 32 ? vpp : 32;
    prow = kStageThreads / span;
  }
};

// Run by thread 0 of each of the blocks that stage one image, after a
// __syncthreads() that follows the block's writes of its partials: arrive
// on the image's counter (release), then wait until it reaches `target`
// arrivals (acquire).
__device__ __forceinline__ void arrive_and_wait(unsigned* arrive,
                                                unsigned target) {
  __threadfence();
  atomicAdd(arrive, 1u);
  while (ld_acquire(arrive) < target) __nanosleep(32);
}

// The forward's one exchange per image among its `ranges` blocks. The last
// block to leave resets both counters (arrive[0], arrive[1]) to zero, so
// the next launch, or CUDA graph replay, finds them clean with no memset.
__device__ __forceinline__ void image_exchange(unsigned* arrive,
                                               unsigned ranges) {
  arrive_and_wait(arrive, ranges);
  if (atomicAdd(arrive + 1, 1u) == ranges - 1) {
    atomicExch(arrive, 0u);
    atomicExch(arrive + 1, 0u);
  }
}

}  // namespace msr
