// Hopper (sm_90a) building blocks for hand-written kernels: TMA tensor
// loads with mbarrier completion, warpgroup matrix products (wgmma) with
// operands in 128-byte-swizzled shared memory, named barriers and register
// reallocation between warpgroups, and the host's tensor-map encoding.
// flash_fwd_sm90.cu (K1), temporal_attn_sm90.cu (K2), flash_fwd_t_sm90.cu
// (K3), flash_fwd_d512_sm90.cu (K4), flash_bwd_sm90.cu (K5),
// flash_int8_sm90.cu (K6), winograd.cu (K8) and layout_copy.cu (K9) use
// them.
//
// Shared-memory operand layout (what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B and a box of 64 bf16 columns writes): each row
// of the box is 128 bytes, and in row r the 16-byte chunk c sits at chunk
// c ^ (r % 8); 8 rows make a 1024-byte swizzle atom, so every tile buffer is
// 1024-byte aligned. wgmma reads such a tile through a matrix descriptor:
// - K-major (the contraction axis is the contiguous one: Q and K in S = QK^T):
//   the 8-row atoms are SBO = 1024 bytes apart; a 16-wide K step moves the
//   start address by 32 bytes inside the 128-byte row (the swizzle is applied
//   to the absolute address), and the next 64 columns are the next box's
//   buffer.
// - MN-major (the output axis is the contiguous one: V in O = P V, keys on
//   the contraction axis): 64 output columns per atom, the next 64 in the
//   next box's buffer, LBO bytes away; 8 keys per atom, the next 8 SBO =
//   1024 bytes away; a 16-key step moves the start address by 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// ---- clusters ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster that has not exited (callable from divergent
// code): shared memory and barriers of the cluster's CTAs are safe to use
// after it, and a CTA outlives its peers' last accesses to it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- TMA ----

// A 4-d tiled load of the box at coordinates (c0 innermost .. c3) into
// shared memory at dst; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same load multicast to the CTAs of the cluster in `mask`: the box
// lands at the same shared-memory offset in each, and completes its bytes
// on the barrier at the same offset in each.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const void* map, uint32_t bar,
                                                      uint16_t mask, int c0, int c1, int c2,
                                                      int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The same for a 5-d map.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d_multicast(uint32_t dst, const void* map, uint32_t bar,
                                                      uint16_t mask, int c0, int c1, int c2,
                                                      int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7, %8}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// A 4-d tiled store of shared memory at src to the box at (c0 .. c3) of a
// tensor map (its parts past the extents are not written), in this thread's
// bulk group.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N of this thread's bulk stores have read
// their shared memory.
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until this thread's bulk stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A plain bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma, TMA) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Zero one 16-byte chunk (columns 8 chunk .. 8 chunk + 7) of rows i,
// i + step, ... < rows of a 128-byte-swizzled box at `box` (1024-byte
// aligned): the contraction's pad columns past d, which under a wide map
// hold the next head's values. The caller fences (fence_proxy_async) and
// synchronises before a wgmma reads them.
__device__ __forceinline__ void zero_chunk_rows(uint32_t box, int chunk, int rows, int i,
                                                int step) {
  for (int r = i; r < rows; r += step) {
    const uint32_t at = box + r * 128 + ((chunk ^ (r & 7)) * 16);
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
  }
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- warpgroups ----

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ----

// Matrix descriptor of a 128-byte-swizzled shared-memory operand (see the
// top of this file for LBO and SBO).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving the reads or writes of a wgmma's registers
// across the fence, commit or wait around it (each register is passed
// through an empty volatile asm, which stays in order with those).
template <int C>
__device__ __forceinline__ void gmma_fence_regs(float (&d)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

template <int C>
__device__ __forceinline__ void gmma_fence_regs(uint32_t (&a)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The accumulator of m64nNk16 (fp32): lane (g = lane / 4, tg = lane % 4) of
// warp w in the warpgroup holds, for each 8-column chunk i, d[i][0..1] at
// row 16 w + g, columns 8 i + 2 tg + {0, 1}, and d[i][2..3] at row
// 16 w + g + 8 -- per chunk the layout of mma.sync m16n8. The register A
// operand of the RS form is mma.sync's m16n8k16 A fragment.
#define HF4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// D(64 x N, f32) += A(64 x 16) B(16 x N), both K-major in shared memory
// (descriptors da, db); scale_d = 0 overwrites D instead.
template <int N>
struct GmmaSS;

// D(64 x N, f32) += A(64 x 16, bf16 registers) B(16 x N), B MN-major in
// shared memory (descriptor db).
template <int N>
struct GmmaRS;

// One specialisation per N (the instruction names N and lists N / 2
// accumulator registers).
template <>
struct GmmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct GmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct GmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], uint64_t da, uint64_t db,
                                             uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct GmmaRS<8> {
  static __device__ __forceinline__ void run(float (&d)[1][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : HF4(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[2][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<24> {
  static __device__ __forceinline__ void run(float (&d)[3][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<40> {
  static __device__ __forceinline__ void run(float (&d)[5][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<48> {
  static __device__ __forceinline__ void run(float (&d)[6][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<56> {
  static __device__ __forceinline__ void run(float (&d)[7][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<72> {
  static __device__ __forceinline__ void run(float (&d)[9][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<80> {
  static __device__ __forceinline__ void run(float (&d)[10][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<88> {
  static __device__ __forceinline__ void run(float (&d)[11][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
        "{%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<96> {
  static __device__ __forceinline__ void run(float (&d)[12][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<104> {
  static __device__ __forceinline__ void run(float (&d)[13][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51}, "
        "{%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<112> {
  static __device__ __forceinline__ void run(float (&d)[14][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<120> {
  static __device__ __forceinline__ void run(float (&d)[15][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
        "{%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<136> {
  static __device__ __forceinline__ void run(float (&d)[17][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15), HF4(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<144> {
  static __device__ __forceinline__ void run(float (&d)[18][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15), HF4(d, 16), HF4(d, 17)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<152> {
  static __device__ __forceinline__ void run(float (&d)[19][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75}, "
        "{%76, %77, %78, %79}, %80, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15), HF4(d, 16), HF4(d, 17),
          HF4(d, 18)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct GmmaRS<160> {
  static __device__ __forceinline__ void run(float (&d)[20][4], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : HF4(d, 0), HF4(d, 1), HF4(d, 2), HF4(d, 3), HF4(d, 4), HF4(d, 5),
          HF4(d, 6), HF4(d, 7), HF4(d, 8), HF4(d, 9), HF4(d, 10), HF4(d, 11),
          HF4(d, 12), HF4(d, 13), HF4(d, 14), HF4(d, 15), HF4(d, 16), HF4(d, 17),
          HF4(d, 18), HF4(d, 19)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef HF4

// ---- host: tensor maps and launch attributes ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A tensor map of `rank` axes (extents innermost first, the byte strides of
// axes 1 .. rank - 1, the box), elements of `type`, with `swizzle`.
bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One operand's map: 4 extents (innermost first), the byte strides of axes
// 1-3, and a bf16 box of 64 columns x `rows` rows, 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* ptr, const long long* dims,
                const long long* strides, int rows) {
  const cuuint64_t ext[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2],
                             (cuuint64_t)dims[3]};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, ext, st, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// Set a kernel's shared-memory limit once per device: `done` is the
// instantiation's own set of devices (one bit each).
template <typename K>
cudaError_t configure_once(K kern, int smem, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace
