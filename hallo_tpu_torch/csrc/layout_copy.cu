// Identity copy of a contiguous tensor into a new one, for Hopper (sm_90a),
// as a ring of bulk copies.
//
// Replaces hallo_tpu/ops/layout.py:28 `_copy_kernel` (K9, launched through
// `layout_anchor`, :32), the layout anchor: on the TPU an identity Pallas
// copy of a (rows, C) view forced XLA to resolve a transposed HBM layout at
// that point. The card has no such tiling; the port's anchor is a fresh
// row-major copy made by this kernel.
//
// What bounds it on this card: bytes, each read once and written once (84 MB
// each way at the denoiser's level-0 activation, (131072, 320) bf16: 0.050 ms
// at 3.35 TB/s). The first port of it (16-byte loads in a grid-stride loop, twice
// as many blocks as fit the card, one load in flight a thread for the last
// 0.9 M vectors) reached 79% of that. Here the grid is persistent (one CTA
// an SM, ops/layout.py: copy_plan), and one thread of each CTA keeps a ring
// of kStages chunks of kChunk bytes in flight: a bulk copy (cp.async.bulk)
// from global memory into a stage completes on the stage's mbarrier, the
// same thread then starts a bulk copy of the stage back out, and refills a
// stage once the store that last read it has read it
// (cp.async.bulk.wait_group.read). No data passes through registers. CTA c
// takes chunks c, c + grid, ..., so the card's accesses at any moment lie in
// one window of the buffers. Both copies carry an L2 evict-first policy:
// no byte is read twice. Measured on an H100 (PERF.md), the SM-side copy
// stays 1-2% behind `clone`'s (cudaMemcpy's copy); 16-byte loads with
// streaming hints, more or fewer CTAs, other chunks and stages, chunks in
// phases or in one span a CTA were no faster.
//
// Bulk copies need 16-byte-aligned addresses and sizes. Where the source and
// the destination sit at the same offset modulo 16, the bytes before the
// first 16-byte boundary (the head) and past the last (the tail) are copied
// one per thread, beside the ring; otherwise every byte is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16384;  // bytes a stage
constexpr int kStages = 12;  // 192 KB a CTA: more bulk copies in flight beat wider ones
constexpr int kSmem = kStages * kChunk + 8 * kStages + 16;  // stages, barriers, alignment

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// the mbarrier `bar`, with an L2 cache policy.
__device__ __forceinline__ void bulk_load_hinted(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// `bytes` from shared src to global dst in this thread's bulk group.
__device__ __forceinline__ void bulk_store_hinted(void* dst, uint32_t src, uint32_t bytes,
                                                  uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// src, dst: nbytes each; [head, head + body) is the 16-byte-aligned part
// (body a multiple of 16, 0 where the two buffers' offsets differ modulo 16).
__global__ void __launch_bounds__(kThreads) layout_copy_kernel(const unsigned char* __restrict__ src,
                                                               unsigned char* __restrict__ dst,
                                                               long long nbytes, long long head,
                                                               long long body) {
  // the head and the tail, a byte a thread
  const long long rest = nbytes - body;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < rest;
       i += (long long)gridDim.x * kThreads) {
    const long long at = i < head ? i : i + body;
    dst[at] = src[at];
  }
  if (threadIdx.x != 0 || body == 0) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 15) & ~15u;
  const uint32_t bars = ring + kStages * kChunk;
  for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
  mbar_init_fence();
  const uint64_t policy = evict_first_policy();

  const long long chunks = (body + kChunk - 1) / kChunk;
  const long long mine = (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto offset = [&](long long i) { return head + (blockIdx.x + i * gridDim.x) * (long long)kChunk; };
  auto bytes = [&](long long i) {
    const long long left = head + body - offset(i);
    return (uint32_t)(left < kChunk ? left : kChunk);
  };
  auto load = [&](long long i) {
    const int s = (int)(i % kStages);
    const uint32_t n = bytes(i);
    mbar_expect_tx(bars + 8 * s, n);
    bulk_load_hinted(ring + s * kChunk, src + offset(i), n, bars + 8 * s, policy);
  };
  for (long long i = 0; i < mine && i < kStages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % kStages);
    mbar_wait(bars + 8 * s, (uint32_t)((i / kStages) & 1));
    bulk_store_hinted(dst + offset(i), ring + s * kChunk, bytes(i), policy);
    // chunk i - 1's store has read its stage: refill it with chunk i - 1 + kStages
    if (i >= 1 && i - 1 + kStages < mine) {
      tma_store_wait_read<1>();
      load(i - 1 + kStages);
    }
  }
  tma_store_wait();
}

}  // namespace

// src, dst: nbytes each, not overlapping; [head, head + body) is 16-byte
// aligned in both and body a multiple of 16 (ops/layout.py: copy_plan);
// `grid` CTAs.
extern "C" int hallo_layout_copy(const void* src, void* dst, long long nbytes, long long head,
                                 long long body, int grid, void* stream) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src) + head;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst) + head;
  if (nbytes <= 0 || head < 0 || body < 0 || head + body > nbytes || body % 16 != 0 ||
      (body > 0 && ((s | d) & 15) != 0) || grid <= 0)
    return (int)cudaErrorInvalidValue;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(layout_copy_kernel, kSmem, configured);
  if (err != cudaSuccess) return (int)err;
  layout_copy_kernel<<<(unsigned)grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes, head,
      body);
  return (int)cudaGetLastError();
}
