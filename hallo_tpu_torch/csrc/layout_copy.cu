// Identity copy of a contiguous tensor into a new one, for Hopper (sm_90a).
//
// Replaces hallo_tpu/ops/layout.py::_copy_kernel (K9), the layout anchor: on
// the TPU an identity Pallas copy of a (rows, C) view forced XLA to resolve a
// transposed HBM layout at that point. The card has no such tiling; the
// port's anchor is a fresh row-major copy made by this kernel.
//
// What bounds it on this card: bytes, each read once and written once (84 MB
// each way at the denoiser's level-0 activation, (131072, 320) bf16: 0.050 ms
// at 3.35 TB/s). So it moves 16 bytes per thread and step, neighbouring
// threads on neighbouring addresses, in a grid-stride loop with four loads
// in flight per thread; the row count needs no divisor, and the bytes past
// the last whole 16-byte vector (a ragged size) are copied one per thread.
// Where a buffer is not 16-byte aligned, every byte takes that tail path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads) layout_copy_kernel(const unsigned char* __restrict__ src,
                                                               unsigned char* __restrict__ dst,
                                                               long long nvec, long long nbytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * stride] = v[u];
  }
  for (; i < nvec; i += stride) d[i] = s[i];
  for (long long b = nvec * 16 + (long long)blockIdx.x * kThreads + threadIdx.x; b < nbytes;
       b += stride)
    dst[b] = src[b];
}

}  // namespace

// src, dst: nbytes each, not overlapping.
extern "C" int hallo_layout_copy(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const long long nvec = aligned ? nbytes / 16 : 0;
  const long long work = nvec > 0 ? nvec : nbytes;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  layout_copy_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nvec, nbytes);
  return (int)cudaGetLastError();
}
