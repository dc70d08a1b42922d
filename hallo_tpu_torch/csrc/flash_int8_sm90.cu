// K6 for Hopper (sm_90a): attention with int8 QK^T scores, in two launches:
// the quantisation prelude as a kernel, then a TMA-fed, warp-specialised
// attention kernel on the tensor cores.
//
// Replaces hallo_tpu/ops/pallas_flash.py:177 `_attention_kernel_t_q8`
// (reached through `_flash_forward_t_q8`, :868, whose prelude :886-895 runs
// in XLA outside the Pallas call): the opt-in (HALLO_INT8_ATTN=1)
// heads-major attention for long key sides at d % 128 != 0 -- on the main
// path the wav2vec2 self-attention at 1024 frames and more (42 s of audio
// and longer: 12 heads, d 64, fp32 q, k, v through the model's
// (B, T, H, d) -> (B, H, T, d) view). The output is in V's type.
//
// What bounds it on this card: bytes. At L 1056 the call reads fp32 q, k and
// v once and writes fp32 o once, 13 MB, 3.9 us at 3.35 TB/s; QK^T is 1.7 G
// int8 operations and PV 1.7 GFLOP bf16, 0.9 + 1.7 us at the tensor cores'
// peaks. At these sizes latency, waves and the host set the pace.
//
// 1. The prelude (`int8_prelude_kernel`), the counterpart of ops/flash.py's
//    `quantize_int8`, in one launch. It reads q, k and v (fp32 or bf16, any
//    (batch, token, head) strides with d contiguous) once and writes:
//    - q8 and k8, int8 rows of DP = d rounded up to 32 bytes (zeros past d):
//      wgmma's int8 k-depth is 32, TMA's global strides are multiples of 16
//      bytes (rows of d 40 bytes could not be one), and no box ever runs
//      past the innermost extent (TMA fills such a box slowly: PERF.md);
//    - qs, Q's per-row scale times scale * log2(e), as `quantize_int8` does;
//    - meta, per key (ks, the bias times log2(e), or 0), and (0, -inf) for
//      the keys from Lk up to a whole number of key tiles, so the attention
//      kernel masks with the bias it adds anyway and never tests a bound;
//    - v16, V rounded to bf16 (`__float2bfloat16_rn`, the rounding the
//      first CUDA port applied before its PV mma) in rows of whole
//      64-column boxes (zeros past d), so TMA feeds V straight to the
//      tensor cores.
//    The K mean runs over the whole key axis of each (b, h), and no K row
//    can be quantised before it is known. A single launch does it with
//    clusters: the 8 CTAs of a cluster split one (b, h)'s rows, each sums
//    its rows' columns, the partial sums are exchanged through distributed
//    shared memory, and every CTA adds the 8 in the same order (so all get
//    the same mean bit for bit) before it quantises its own rows, which it
//    reads again from L2. A second pass would cost a launch (the call is two
//    launches), and one CTA a (b, h) would stream a whole head through one SM
//    twice (1 MB at L 4096). Q's and V's rows run in other clusters of the
//    same grid, independently. Exactness: division by IEEE `__fdiv_rn`,
//    rounding by cvt.rni (half to even), a clip to +-127, and the scale's
//    `/ 127` as torch computes it on the card (a multiply by the float
//    reciprocal of the CPU scalar); so q8 and qs equal `quantize_int8`'s on
//    the card bit for bit, and k8 and ks may differ only where the K mean's
//    summation order moves a value across a rounding boundary.
//
// 2. The attention kernel (`flash_int8_sm90_kernel`), K1's design
//    (flash_fwd_sm90.cu) on these operands:
//    - a producer warpgroup whose one thread keeps a ring of 3 stages of
//      k8 tiles (with their meta) and v16 tiles in flight by TMA, one box a
//      tile (4-d maps over (32 bytes | 64 columns, L, column blocks, B H)),
//      with full and empty mbarriers; every consumer warp waits on every
//      phase of every stage;
//    - 2 consumer warpgroups of 64 query rows, or 3 up to d 64 where 2 would
//      take more waves of one CTA an SM (ops/flash.py: _consumers): S = q8
//      k8^T by `wgmma m64nBNk32.s32.s8.s8`, both operands K-major (as 8-bit
//      wgmma requires: the natural layout of q8 and k8) in 32-byte-swizzled
//      column blocks of 32 bytes, one block a k-step;
//    - the dequantisation S ks[key] qs[row] + bias log2 e in registers; then
//      K1's base-2 online softmax
//      (flash_common.cuh: tile_softmax); P repacked to bf16 as the register
//      A operand of O += P V, with V MN-major in 128-byte-swizzled boxes
//      (K1's descriptor); S_t and PV_{t-1} issued in one turn, the
//      warpgroups taking turns on named barriers (FlashAttention-3);
//    - a row whose keys are all masked gives 0; keys past Lk are masked by
//      meta's -inf and read as 0 by TMA; query rows past Lq are computed on
//      zeros and not stored.
//    The grid is (query blocks, H, B): at L 1056, 9 blocks of 128 rows a
//    head, 108 CTAs of two consumer warpgroups (72 of three took 20% longer
//    on an H100, PERF.md §6); at L 4096, 264 CTAs of three, two waves of
//    one CTA an SM (384 of two took 24% longer). K/V of one head at L 1056
//    is 200 KB in int8 and bf16, so the ring, not whole-head residency,
//    serves every length.
//
// The host encodes the three tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint) and passes them as __grid_constant__
// parameters; every other launch integer comes in one array that the
// wrapper caches by shape (ops/flash.py: int8_plan).

#include <cuda.h>

#include <chrono>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// ---- the prelude ----

constexpr int kPreludeCluster = 8;  // CTAs that share one (b, h)'s K mean
constexpr int kPreludeThreads = 256;
constexpr int kPreludeWarps = kPreludeThreads / 32;
constexpr int kMaxD = 160;
// Row slots of a CTA: warps x rows a warp takes at once (at least 8 lanes a
// row, since q8/k8 rows are at least 32 bytes).
constexpr int kMaxSlots = kPreludeWarps * 4;
// torch's `x / 127.0` on a CUDA tensor: x times the float reciprocal.
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kScaleFloor = 1e-8f;

struct PreludeParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Lk) natural-log units, or nullptr
  int8_t* q8;         // (B H, Lq, DP)
  int8_t* k8;         // (B H, Lk, DP)
  float* qs;          // (B H, Lq), times qs_mul
  float* meta;        // (B H, Lk_pad, 2): (ks, bias log2 e)
  bf16* v16;          // (B H, Lk, DVP)
  int B, H, Lq, Lk, D, DP, DVP, Lk_pad;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, bias_sb;
  float qs_mul;  // softmax scale * log2(e)
};

// 4 consecutive values at p as floats (fp32: one 16-byte load; bf16: 8 bytes).
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

__device__ __forceinline__ float amax4(float4 x) {
  return fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
}

// round(x / s) half to even, clipped to +-127, as one int8 byte
__device__ __forceinline__ uint32_t quant(float x, float s) {
  const int v = __float2int_rn(__fdiv_rn(x, s));
  return (uint32_t)(max(-127, min(127, v)) & 0xff);
}

__device__ __forceinline__ uint32_t quant4(float4 x, float s) {
  return quant(x.x, s) | (quant(x.y, s) << 8) | (quant(x.z, s) << 16) | (quant(x.w, s) << 24);
}

// The max of x over the `lpr` lanes of a row (aligned groups, lpr a power of 2).
__device__ __forceinline__ float group_max(float x, int lpr) {
  for (int o = lpr >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One float from the same shared-memory offset in CTA `cta` of the cluster.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  float x;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n}\n"
      : "=f"(x)
      : "r"(smem_u32(p)), "r"(cta)
      : "memory");
  return x;
}

// Grid (kPreludeCluster, B H, 3): blockIdx.z 0 quantises K (its clusters
// share the mean), 1 quantises Q, 2 rounds V to bf16. CTA x of a cluster
// takes rows [x share, (x + 1) share). A warp takes 32 / lpr rows at a time,
// lpr lanes a row, 4 columns a lane (and 4 more 4 lpr columns on), and
// kUnroll such row groups a step, whose loads it issues before it uses any:
// one row group at a time left every pass waiting on one DRAM round trip a
// row group.
constexpr int kUnroll = 4;

template <typename T>
__global__ void __cluster_dims__(kPreludeCluster, 1, 1) __launch_bounds__(kPreludeThreads)
    int8_prelude_kernel(const PreludeParams p) {
  __shared__ float red[kMaxSlots][kMaxD];  // K: each row slot's column sums
  __shared__ float part[kMaxD];            // K: this CTA's column sums
  __shared__ float mean[kMaxD];
  const int kind = blockIdx.z;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int L = kind == 1 ? p.Lq : p.Lk;
  const int share = (L + kPreludeCluster - 1) / kPreludeCluster;
  const int r0 = blockIdx.x * share, r1 = min(L, r0 + share);
  const int width = kind == 2 ? p.DVP : p.DP;  // the output row's columns
  int lpr = 8;
  while (lpr < 32 && lpr * 4 < width) lpr <<= 1;
  const int rpw = 32 / lpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / lpr;
  const int c0 = (lane % lpr) * 4, c1 = c0 + 4 * lpr;  // this lane's two column groups
  const int slot = warp * rpw + sub, slots = kPreludeWarps * rpw;
  const T* src;
  long long sl;
  if (kind == 0) {
    src = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    sl = p.k_sl;
  } else if (kind == 1) {
    src = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    sl = p.q_sl;
  } else {
    src = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    sl = p.v_sl;
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // row groups: every lane of a warp runs every step (the shuffles)
  const int first = r0 + warp * rpw, step = slots;
  // this lane's columns of row r (zeros past d, or for a row past the CTA's)
  float4 x0[kUnroll], x1[kUnroll];
  auto load_rows = [&](int rb) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * step + sub;
      x0[u] = zero4;
      x1[u] = zero4;
      if (r < r1) {
        const T* row = src + r * sl;
        if (c0 < p.D) x0[u] = load4(row + c0);
        if (c1 < p.D) x1[u] = load4(row + c1);
      }
    }
  };

  if (kind == 0) {
    // ---- the K mean: this CTA's column sums, then the cluster's ----
    float4 s0 = zero4, s1 = zero4;
    for (int rb = first; rb < r1; rb += kUnroll * step) {
      load_rows(rb);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s0.x += x0[u].x; s0.y += x0[u].y; s0.z += x0[u].z; s0.w += x0[u].w;
        s1.x += x1[u].x; s1.y += x1[u].y; s1.z += x1[u].z; s1.w += x1[u].w;
      }
    }
    if (c0 < p.D) *reinterpret_cast<float4*>(&red[slot][c0]) = s0;
    if (c1 < p.D) *reinterpret_cast<float4*>(&red[slot][c1]) = s1;
    __syncthreads();
    if (threadIdx.x < p.D) {
      float s = 0.f;
      for (int i = 0; i < slots; ++i) s += red[i][threadIdx.x];
      part[threadIdx.x] = s;
    }
    cluster_sync();  // every CTA's partial sums are written
    if (threadIdx.x < p.D) {
      float s = 0.f;
      for (int c = 0; c < kPreludeCluster; ++c) s += ld_cluster(&part[threadIdx.x], c);
      mean[threadIdx.x] = s / (float)p.Lk;
    }
    __syncthreads();
    // ---- K rows: centre, scale, quantise; meta = (ks, bias log2 e) ----
    int8_t* dst = p.k8 + (long long)bh * p.Lk * p.DP;
    float* meta = p.meta + (long long)bh * p.Lk_pad * 2;
    const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
    for (int rb = first; rb < r1; rb += kUnroll * step) {
      load_rows(rb);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u * step + sub;
        float4& y0 = x0[u];
        float4& y1 = x1[u];
        if (c0 < p.D) {
          y0.x -= mean[c0]; y0.y -= mean[c0 + 1]; y0.z -= mean[c0 + 2]; y0.w -= mean[c0 + 3];
        }
        if (c1 < p.D) {
          y1.x -= mean[c1]; y1.y -= mean[c1 + 1]; y1.z -= mean[c1 + 2]; y1.w -= mean[c1 + 3];
        }
        const float ks = fmaxf(group_max(fmaxf(amax4(y0), amax4(y1)), lpr) * kInv127, kScaleFloor);
        if (r < r1) {
          int8_t* out = dst + (long long)r * p.DP;
          if (c0 < p.DP) *reinterpret_cast<uint32_t*>(out + c0) = c0 < p.D ? quant4(y0, ks) : 0u;
          if (c1 < p.DP) *reinterpret_cast<uint32_t*>(out + c1) = c1 < p.D ? quant4(y1, ks) : 0u;
          if (lane % lpr == 0)
            *reinterpret_cast<float2*>(meta + 2 * r) =
                make_float2(ks, bias ? bias[r] * kLog2e : 0.f);
        }
      }
    }
    // keys Lk .. Lk_pad: no scale, masked
    if (blockIdx.x == 0)
      for (int r = p.Lk + threadIdx.x; r < p.Lk_pad; r += kPreludeThreads)
        *reinterpret_cast<float2*>(meta + 2 * r) = make_float2(0.f, -INFINITY);
    cluster_sync();  // no CTA exits while a peer may read its partial sums
  } else if (kind == 1) {
    // ---- Q rows: scale, quantise; qs times scale * log2 e ----
    int8_t* dst = p.q8 + (long long)bh * p.Lq * p.DP;
    float* qs = p.qs + (long long)bh * p.Lq;
    for (int rb = first; rb < r1; rb += kUnroll * step) {
      load_rows(rb);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u * step + sub;
        const float s =
            fmaxf(group_max(fmaxf(amax4(x0[u]), amax4(x1[u])), lpr) * kInv127, kScaleFloor);
        if (r < r1) {
          int8_t* out = dst + (long long)r * p.DP;
          if (c0 < p.DP) *reinterpret_cast<uint32_t*>(out + c0) = c0 < p.D ? quant4(x0[u], s) : 0u;
          if (c1 < p.DP) *reinterpret_cast<uint32_t*>(out + c1) = c1 < p.D ? quant4(x1[u], s) : 0u;
          if (lane % lpr == 0) qs[r] = s * p.qs_mul;
        }
      }
    }
  } else {
    // ---- V rows to bf16, zeros past d (width DVP: two column groups cover it) ----
    bf16* dst = p.v16 + (long long)bh * p.Lk * p.DVP;
    for (int rb = first; rb < r1; rb += kUnroll * step) {
      load_rows(rb);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u * step + sub;
        if (r >= r1) continue;
        bf16* out = dst + (long long)r * p.DVP;
        if (c0 < p.DVP)
          *reinterpret_cast<uint2*>(out + c0) =
              make_uint2(pack_bf16(x0[u].x, x0[u].y), pack_bf16(x0[u].z, x0[u].w));
        if (c1 < p.DVP)
          *reinterpret_cast<uint2*>(out + c1) =
              make_uint2(pack_bf16(x1[u].x, x1[u].y), pack_bf16(x1[u].z, x1[u].w));
      }
    }
  }
}

// ---- the attention kernel ----

// NC consumer warpgroups of 64 query rows: 2 or, up to d 64, 3 (registers;
// ops/flash.py chooses: the fewer rows a CTA, the more CTAs, unless that
// takes another wave)
template <int DP, int NC>
struct Int8Tiles {
  static_assert(NC == 2 || (NC == 3 && DP <= 64), "consumer warpgroups");
  static constexpr int kConsumers = NC;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;  // producer: 24
  static constexpr int kDVP = (DP + 63) / 64 * 64;  // v16's row: whole 64-column boxes
  static constexpr int kVBoxes = kDVP / 64;
  static constexpr int kBlocks = DP / 32;  // q8/k8's 32-byte column blocks
  static constexpr int kBlockK = kDVP <= 128 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBlockQ * DP;
  static constexpr int kKBytes = kBlockK * DP;
  static constexpr int kVBox = kBlockK * 128;
  static constexpr int kVBytes = kVBoxes * kVBox;
  static constexpr int kMetaBytes = kBlockK * 8;
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmem =
      kStages * (kVBytes + kKBytes + kMetaBytes) + kQBytes + 8 * kBarriers + 1024;
  static_assert(kSmem <= 232448, "shared memory");
};

// wgmma descriptor of a K-major operand in 32-byte-swizzled column blocks
// (a row of 32 bytes, 8-row atoms SBO = 256 bytes apart; LBO unused).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

// S(64 x N, s32) = A(64 x 32, s8) B(32 x N, s8), both K-major in shared
// memory: `first` overwrites S (its outputs only, so the compiler keeps no
// stale scores alive across a tile), `add` accumulates the next k-step.
template <int N>
struct GmmaS8;

#define HO4(d, i) "=r"(d[i][0]), "=r"(d[i][1]), "=r"(d[i][2]), "=r"(d[i][3])
#define HI4(d, i) "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])
template <>
struct GmmaS8<64> {
  static __device__ __forceinline__ void first(uint32_t (&d)[8][4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : HO4(d, 0), HO4(d, 1), HO4(d, 2), HO4(d, 3), HO4(d, 4), HO4(d, 5), HO4(d, 6), HO4(d, 7)
        : "l"(da), "l"(db), "r"(0));
  }
  static __device__ __forceinline__ void add(uint32_t (&d)[8][4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : HI4(d, 0), HI4(d, 1), HI4(d, 2), HI4(d, 3), HI4(d, 4), HI4(d, 5), HI4(d, 6), HI4(d, 7)
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct GmmaS8<128> {
  static __device__ __forceinline__ void first(uint32_t (&d)[16][4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : HO4(d, 0), HO4(d, 1), HO4(d, 2), HO4(d, 3), HO4(d, 4), HO4(d, 5),
          HO4(d, 6), HO4(d, 7), HO4(d, 8), HO4(d, 9), HO4(d, 10), HO4(d, 11),
          HO4(d, 12), HO4(d, 13), HO4(d, 14), HO4(d, 15)
        : "l"(da), "l"(db), "r"(0));
  }
  static __device__ __forceinline__ void add(uint32_t (&d)[16][4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : HI4(d, 0), HI4(d, 1), HI4(d, 2), HI4(d, 3), HI4(d, 4), HI4(d, 5),
          HI4(d, 6), HI4(d, 7), HI4(d, 8), HI4(d, 9), HI4(d, 10), HI4(d, 11),
          HI4(d, 12), HI4(d, 13), HI4(d, 14), HI4(d, 15)
        : "l"(da), "l"(db), "r"(1));
  }
};
#undef HO4
#undef HI4

constexpr int kBarSched = 1;  // named barriers 1 .. consumers: the turns

// An int32 score as a float, exactly for |x| < 2^22 (|S| <= 160 127^2 <
// 2^22): x rides in the mantissa of 1.5 2^23, an integer add and a float
// subtraction on the full-rate pipes, where a conversion instruction would
// share the 16-a-clock pipe of the softmax's ex2s (5% of the kernel's time
// at L 4096 on an H100, none at L 1056: PERF.md §6).
__device__ __forceinline__ float s32_to_f32(uint32_t x) {
  return __int_as_float((int)x + 0x4B400000) - 12582912.f;
}

struct Int8Params {
  const float* qs;    // (B H, Lq), times scale * log2 e
  const float* meta;  // (B H, Lk_pad, 2)
  void* o;            // (B, H, Lq, D) contiguous, V's type
  int H, Lq, Lk, D, Lk_pad;
  int out_f32;
};

// DP: d rounded up to 32 (the contraction of S in int8 and the width of O,
// whose columns past d are v16's zeros and are not stored).
template <int DP, int NC>
__global__ void __launch_bounds__(Int8Tiles<DP, NC>::kThreads, 1)
    flash_int8_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Int8Params p) {
  using T = Int8Tiles<DP, NC>;
  constexpr int BN = T::kBlockK, ST = T::kStages, NB = T::kBlocks;
  constexpr int KT = BN / 8, DT = DP / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sV = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = sV + ST * T::kVBytes;
  const uint32_t sK = sQ + T::kQBytes;
  const uint32_t sM = sK + ST * T::kKBytes;  // per stage: the tile's (ks, bias) pairs
  const uint32_t bars = sM + ST * T::kMetaBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int b = blockIdx.z, h = blockIdx.y;
  const int bh = b * p.H + h;
  constexpr int kConsumers = T::kConsumers;
  const int q0 = blockIdx.x * T::kBlockQ;
  const int nkv = (p.Lk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(q_full, T::kQBytes);
      tma_load_4d(sQ, &tq, q_full, 0, q0, 0, bh);
      const float* meta = p.meta + (long long)bh * p.Lk_pad * 2;
      for (int t = 0; t < nkv; ++t) {
        const int s = t % ST;
        const uint32_t released = ((t / ST) + 1) & 1;  // tile t - ST's parity
        if (t >= ST) mbar_wait(k_empty(s), released);
        mbar_expect_tx(k_full(s), T::kKBytes + T::kMetaBytes);
        tma_load_4d(sK + s * T::kKBytes, &tk, k_full(s), 0, t * BN, 0, bh);
        bulk_load(sM + s * T::kMetaBytes, meta + 2 * t * BN, T::kMetaBytes, k_full(s));
        if (t >= ST) mbar_wait(v_empty(s), released);
        mbar_expect_tx(v_full(s), T::kVBytes);
        tma_load_4d(sV + s * T::kVBytes, &tv, v_full(s), 0, t * BN, 0, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
    const float* qsb = p.qs + (long long)bh * p.Lq;
    const float qs0 = row0 < p.Lq ? qsb[row0] : 0.f;
    const float qs1 = row0 + 8 < p.Lq ? qsb[row0 + 8] : 0.f;
    const float* meta_tiles = reinterpret_cast<const float*>(smem_raw + (sM - smem_u32(smem_raw)));
    const uint32_t qa = sQ + cw * 64 * 32;  // this warpgroup's rows in each column block

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    uint32_t si[KT][4];       // S_t in int32
    float sc[KT][4];          // S_t's scores, then its probabilities
    uint32_t pf[BN / 16][4];  // tile t - 1's probabilities, bf16: PV's A operand

    // S_t = q8 k8_t^T from stage s, one 32-byte column block a k-step
    auto issue_s = [&](int s) {
      GmmaS8<BN>::first(si, desc_sw32(qa), desc_sw32(sK + s * T::kKBytes));
#pragma unroll
      for (int ks = 1; ks < NB; ++ks)
        GmmaS8<BN>::add(si, desc_sw32(qa + ks * T::kBlockQ * 32),
                        desc_sw32(sK + s * T::kKBytes + ks * BN * 32));
    };
    // O += P V from stage s (V MN-major: LBO the next 64 columns' box, SBO
    // the next 8 keys; a 16-key step is 2048 bytes)
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        GmmaRS<DP>::run(acc, pf[kk], gmma_desc(sV + s * T::kVBytes + kk * 2048, T::kVBox, 1024));
    };
    // S ks[key] qs[row] + bias[key] log2 e (-inf past Lk), then the softmax
    auto softmax_tile = [&](int t, float (&alpha)[2]) {
      const float* mt = meta_tiles + (t % ST) * BN * 2;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const float4 m = *reinterpret_cast<const float4*>(mt + (i * 8 + tg * 2) * 2);
        sc[i][0] = fmaf(s32_to_f32(si[i][0]) * m.x, qs0, m.y);
        sc[i][1] = fmaf(s32_to_f32(si[i][1]) * m.z, qs0, m.w);
        sc[i][2] = fmaf(s32_to_f32(si[i][2]) * m.x, qs1, m.y);
        sc[i][3] = fmaf(s32_to_f32(si[i][3]) * m.z, qs1, m.w);
      }
      tile_softmax(sc, m_r, l_r, alpha, 1.f, nullptr, 0, 0x7fffffff, tg);
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pf[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pf[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pf[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pf[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      gmma_fence_regs(pf);
    };
    auto turn_begin = [&]() {
      named_sync(kBarSched + cw, 2 * 128);
      gmma_fence_regs(acc);
      gmma_fence();
    };
    auto turn_end = [&]() { named_arrive(kBarSched + (cw + 1) % kConsumers, 2 * 128); };
    if (cw == kConsumers - 1) named_arrive(kBarSched + 0, 2 * 128);
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(q_full, 0);

    // tile 0: S_0 only
    mbar_wait(k_full(0), 0);
    turn_begin();
    issue_s(0);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(si);
    {
      float alpha[2];
      softmax_tile(0, alpha);  // the output is still 0: nothing to rescale
    }
    release(k_empty(0));  // k8_0 and its meta
    pack_p();

    // tile t: S_t with O += P_{t-1} V_{t-1} in one turn, then S_t's softmax
    // while the PV product runs
    for (int t = 1; t < nkv; ++t) {
      const int s = t % ST, sp = (t - 1) % ST;
      mbar_wait(k_full(s), (t / ST) & 1);
      mbar_wait(v_full(sp), ((t - 1) / ST) & 1);
      turn_begin();
      issue_s(s);
      gmma_commit();
      issue_pv(sp);
      gmma_commit();
      turn_end();
      gmma_wait<1>();
      gmma_fence_regs(si);
      float alpha[2];
      softmax_tile(t, alpha);
      release(k_empty(s));
      gmma_wait<0>();
      gmma_fence_regs(acc);
      release(v_empty(sp));
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      pack_p();
    }

    // the last PV product
    const int sl = (nkv - 1) % ST;
    mbar_wait(v_full(sl), ((nkv - 1) / ST) & 1);
    turn_begin();
    issue_pv(sl);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(acc);
    if (cw == 0) named_sync(kBarSched + 0, 2 * 128);  // the last hand-over

    const long long obase = (long long)bh * p.Lq * p.D;
    if (p.out_f32)
      store_rows<float, DT>(static_cast<float*>(p.o) + obase, p.D, acc, l_r, row0, p.Lq, 0, p.D,
                            tg);
    else
      store_rows<bf16, DT>(static_cast<bf16*>(p.o) + obase, p.D, acc, l_r, row0, p.Lq, 0, p.D,
                           tg);
  }
}

// ---- host ----

// The launch array (ops/flash.py: int8_plan's `args`).
enum Arg {
  kB, kH, kLq, kLk, kD, kDP, kDVP, kLkPad, kDtype,  // dtype: 0 bf16, 1 fp32 (q, k, v, o)
  kQsb, kQsl, kQsh, kKsb, kKsl, kKsh, kVsb, kVsl, kVsh, kBiasSb,
  kBlockQ, kBlockK, kStagesArg,
  kArgs
};

template <typename T>
cudaError_t launch_prelude(const PreludeParams& p, cudaStream_t st) {
  const dim3 grid(kPreludeCluster, p.B * p.H, 3);
  int8_prelude_kernel<T><<<grid, kPreludeThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// The three tensor maps of the attention kernel: q8 and k8 as (32 bytes,
// L, DP / 32 column blocks, B H) with 32-byte swizzle, v16 as (64 columns,
// Lk, DVP / 64, B H) with 128-byte swizzle; one box a tile.
bool encode_int8_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q8,
                      const void* k8, const void* v16, const long long* a, int block_q,
                      int block_k) {
  const cuuint64_t bh = (cuuint64_t)(a[kB] * a[kH]);
  const cuuint64_t dp = (cuuint64_t)a[kDP], dvp = (cuuint64_t)a[kDVP];
  const cuuint64_t lq = (cuuint64_t)a[kLq], lk = (cuuint64_t)a[kLk];
  const cuuint64_t qd[4] = {32, lq, dp / 32, bh}, qs[3] = {dp, 32, lq * dp};
  const cuuint64_t kd[4] = {32, lk, dp / 32, bh}, ks[3] = {dp, 32, lk * dp};
  const cuuint64_t vd[4] = {64, lk, dvp / 64, bh}, vs[3] = {2 * dvp, 128, 2 * lk * dvp};
  const cuuint32_t qb[4] = {32, (cuuint32_t)block_q, (cuuint32_t)(dp / 32), 1};
  const cuuint32_t kb[4] = {32, (cuuint32_t)block_k, (cuuint32_t)(dp / 32), 1};
  const cuuint32_t vb[4] = {64, (cuuint32_t)block_k, (cuuint32_t)(dvp / 64), 1};
  return encode_tiled(tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, q8, qd, qs, qb,
                      CU_TENSOR_MAP_SWIZZLE_32B) &&
         encode_tiled(tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, k8, kd, ks, kb,
                      CU_TENSOR_MAP_SWIZZLE_32B) &&
         encode_tiled(tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v16, vd, vs, vb,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP, int NC>
cudaError_t launch_attention(const void* q8, const void* k8, const void* v16,
                             const long long* a, const Int8Params& p, cudaStream_t stream) {
  using T = Int8Tiles<DP, NC>;
  if (a[kBlockQ] != T::kBlockQ || a[kBlockK] != T::kBlockK || a[kStagesArg] != T::kStages ||
      a[kDVP] != T::kDVP || a[kLkPad] % T::kBlockK != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_int8_maps(&tq, &tk, &tv, q8, k8, v16, a, T::kBlockQ, T::kBlockK))
    return cudaErrorInvalidValue;
  auto kern = flash_int8_sm90_kernel<DP, NC>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, T::kSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + T::kBlockQ - 1) / T::kBlockQ, p.H, (int)a[kB]);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

bool valid(const long long* a) {
  return a[kB] > 0 && a[kH] > 0 && a[kLq] > 0 && a[kLk] > 0 && a[kD] > 0 && a[kD] % 8 == 0 &&
         a[kD] <= kMaxD && a[kDP] == (a[kD] + 31) / 32 * 32 &&
         a[kDVP] == (a[kDP] + 63) / 64 * 64 && a[kLkPad] >= a[kLk];
}

}  // namespace

// The prelude: q, k, v (bf16 or fp32, `args`' dtype and strides) and the
// optional fp32 (B, Lk) bias -> q8, k8, qs, meta, v16 (see the top).
extern "C" int hallo_int8_prelude(const void* q, const void* k, const void* v, const void* bias,
                                  void* q8, void* k8, void* qs, void* meta, void* v16,
                                  const long long* args, float qs_mul, void* stream) {
  const long long* a = args;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  PreludeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.q8 = static_cast<int8_t*>(q8);
  p.k8 = static_cast<int8_t*>(k8);
  p.qs = static_cast<float*>(qs);
  p.meta = static_cast<float*>(meta);
  p.v16 = static_cast<bf16*>(v16);
  p.B = (int)a[kB]; p.H = (int)a[kH]; p.Lq = (int)a[kLq]; p.Lk = (int)a[kLk];
  p.D = (int)a[kD]; p.DP = (int)a[kDP]; p.DVP = (int)a[kDVP]; p.Lk_pad = (int)a[kLkPad];
  p.q_sb = a[kQsb]; p.q_sl = a[kQsl]; p.q_sh = a[kQsh];
  p.k_sb = a[kKsb]; p.k_sl = a[kKsl]; p.k_sh = a[kKsh];
  p.v_sb = a[kVsb]; p.v_sl = a[kVsl]; p.v_sh = a[kVsh];
  p.bias_sb = a[kBiasSb];
  p.qs_mul = qs_mul;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a[kDtype] == 0) return (int)launch_prelude<bf16>(p, st);
  if (a[kDtype] == 1) return (int)launch_prelude<float>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The attention kernel on the prelude's buffers, writing o (B, H, Lq, D)
// contiguous in `args`' dtype.
extern "C" int hallo_flash_int8_sm90(const void* q8, const void* k8, const void* v16,
                                     const void* meta, const void* qs, void* o,
                                     const long long* args, void* stream) {
  const long long* a = args;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  Int8Params p;
  p.qs = static_cast<const float*>(qs);
  p.meta = static_cast<const float*>(meta);
  p.o = o;
  p.H = (int)a[kH]; p.Lq = (int)a[kLq]; p.Lk = (int)a[kLk]; p.D = (int)a[kD];
  p.Lk_pad = (int)a[kLkPad];
  p.out_f32 = a[kDtype] == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool three = a[kBlockQ] == 192;  // else 2 consumer warpgroups (checked at launch)
  switch (a[kDP]) {
    case 32:
      return (int)(three ? launch_attention<32, 3>(q8, k8, v16, a, p, st)
                         : launch_attention<32, 2>(q8, k8, v16, a, p, st));
    case 64:
      return (int)(three ? launch_attention<64, 3>(q8, k8, v16, a, p, st)
                         : launch_attention<64, 2>(q8, k8, v16, a, p, st));
    case 96: return (int)launch_attention<96, 2>(q8, k8, v16, a, p, st);
    case 128: return (int)launch_attention<128, 2>(q8, k8, v16, a, p, st);
    case 160: return (int)launch_attention<160, 2>(q8, k8, v16, a, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Host nanoseconds of `iters` encodings of the attention kernel's three
// tensor maps (the per-call host work the maps add), or -1 if one fails.
extern "C" int hallo_flash_int8_encode_ns(const void* q8, const void* k8, const void* v16,
                                          const long long* args, int iters) {
  CUtensorMap tq, tk, tv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_int8_maps(&tq, &tk, &tv, q8, k8, v16, args, (int)args[kBlockQ],
                          (int)args[kBlockK]))
      return -1;
  return (int)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}
