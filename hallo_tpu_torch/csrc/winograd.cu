// K8 for Hopper (sm_90a): Winograd F(2x2, 3x3) convolution (3x3, stride 1,
// zero padding 1), NHWC input, bf16 or fp32 I/O: a persistent kernel with
// TMA loads and stores, wgmma products, and a producer warpgroup beside two
// consumer warpgroups.
//
// Replaces hallo_tpu/ops/pallas_winograd.py:66 `_wino_kernel` (launched at
// :237 through `winograd_conv3x3`, :177). Each 2x2 output tile (i, j) reads
// the 4x4 input patch d at rows 2i - 1 .., columns 2j - 1 ..; then
//   V[a][b] = (B^T d B)[a][b]     the input transform, per channel;
//   M[a][b] = V[a][b] @ U[a][b]   16 products over the channels, U = G w G^T;
//   Y       = A^T M A             the output transform, 2x2 pixels a tile;
// plus the fp32 bias. U is (16, C, Co) bf16, position a * 4 + b
// (ops/winograd.py: kernel_weights); fp32 x is read as fp32 and its V
// rounded to bf16 for the tensor cores.
//
// What bounds it on this card: the 16 products, 2 * 16 * T * C * Co
// operations for T tiles, take 0.109 ms at the denoiser's level-0 resnet
// shape, (32, 64, 64, 320) -> 320, at 989 TFLOP/s; the bytes of x, U and y
// 0.051 ms. V and M are 16x the size of x and y, so neither reaches device
// memory. Measured (PERF.md), the stream of halos and U slices into shared
// memory sets the floor (loads and stores alone take 60% of the time) and
// the transform and the products add to it rather than hide under it.
//
// What the design does about each limit of the earlier, simple design (its
// copies, transform and products did not overlap; it was L2-bound: every
// block read all 64 of U's columns for 32 tiles, and every Co block re-read
// each tile's 4x4 patch; no TMA, multicast or wgmma):
// - A unit of work is 8 x 8 tiles (16 x 16 output pixels) x 64 output
//   channels. Its input is the 18 x 18-pixel halo, read once per 16
//   channels as one TMA box of a 4-d map over (C, W, H, N) whose
//   out-of-bounds zero fill is the padding: no patch is read twice. The
//   box's 32-byte pixels land with a 32-byte swizzle (a 64-byte one with a
//   32-byte box row misplaced the data), which leaves the transform's
//   ldmatrix reads 2-way bank-conflicted (4-way without it).
// - U: the step's slice (16 positions x 16 channels x 64 outputs, 32 KB)
//   comes by TMA, multicast over a cluster of two CTAs that share the
//   output channels and differ in patches: each loads 8 of the positions
//   for both, halving U's L2 traffic (a cluster of 4 was slower).
// - Overlap: one thread of the producer warpgroup keeps a ring of (halo, U)
//   stages full; the products are asynchronous wgmma, so one consumer's
//   transform runs beside the other's products. The grid is persistent
//   (one CTA an SM, clusters walking the units a grid apart, the channel
//   slices of a patch pair together so that their halos are shared in L2),
//   so the producer loads the next unit while the consumers store this one.
// - Registers: 16 positions x 64 tiles x 64 outputs of fp32 M would be 256
//   registers a thread over two warpgroups. The output transform is linear,
//   so the sums over a are folded into the products: R[rp][b] =
//   sum_a A^T[rp][a] M[a][b] accumulates +-V[a][b] U[a][b] directly (wgmma's
//   negated-A form), 6 products per b instead of 4; each consumer warpgroup
//   owns two of the four b (128 registers of R, 232 a thread after
//   setmaxnreg) and computes V only for them, from 18 pixel loads a channel
//   half that its two b share. The last fold over b, Y = R A, sums the two
//   warpgroups' halves through shared memory, one column parity at a time.
// - wgmma: the products are m64n64k16 with V from registers (the transform
//   writes it in the A-fragment layout: rows are tiles, columns channels)
//   and U MN-major from shared memory (128-byte swizzle).
// - Output: the unit's 16 x 16 x 64 tile goes to shared memory (bf16 with a
//   128-byte swizzle) and out with one TMA store, which writes nothing past
//   the image, the batch or Co (scattered 4-byte stores from registers took
//   about 0.12 ms at level 0).
//
// The host encodes the three tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, no -lcuda).

#include <cuda.h>

#include <type_traits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kCluster = 2;  // CTAs that share each U slice (multicast)
constexpr int kTilesSide = 8;   // a block's tiles: 8 x 8
constexpr int kHalo = 2 * kTilesSide + 2;  // its 18 x 18 input pixels
constexpr int kCK = 16;         // input channels a step (one k16 product)
constexpr int kTN = 64;         // output channels a block
constexpr int kConsumerThreads = 256;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 fits the SM's
// 65536 (ptxas gives a 384-thread block 168 at launch; 24 for the producer
// spilled its unit loop, 20% slower at level 0)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kUBytes = 16 * kCK * kTN * 2;  // one step's U slice: 32 KB
constexpr int kBarExchange = 1;

template <typename T>
struct Stage {
  static constexpr int kHaloBytes = kHalo * kHalo * kCK * sizeof(T);  // the TMA box
  static constexpr int kHaloPad = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kBytes = kHaloPad + kUBytes;
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 3;
  // the epilogue's buffer: half the exchange of R (32 KB), then the output
  // tile (16 x 16 pixels x 64 channels) that one TMA store writes
  static constexpr int kOutBytes = 16 * 16 * kTN * sizeof(T);
  static constexpr int kEpilogue = kOutBytes > 32768 ? kOutBytes : 32768;
  static constexpr int kSmem = kStages * kBytes + kEpilogue + 8 * 2 * kStages + 1024;
  static_assert(kSmem <= 232448, "shared memory");
};

struct WinoParams {
  const float* bias;  // (Co) or null
  int Co;             // a multiple of 8
  int tiles_h, tiles_w;  // H / 2, W / 2
  int patches_w, patches_hw;  // 8 x 8-tile patches along W, per image
  int patch_pairs;    // patches of all images, in pairs (the clusters' units)
  int co_tiles;       // 64-channel slices of Co
  int steps;          // C / kCK
};

// The 64-byte swizzle of TMA (CU_TENSOR_MAP_SWIZZLE_64B): the 16-byte chunk
// bits 4-5 of an offset in a 1024-byte-aligned buffer XOR bits 7-8.
__device__ __forceinline__ uint32_t swz64(uint32_t off) { return off ^ (((off >> 7) & 3u) << 4); }
// The 32-byte swizzle: bit 4 XOR bit 7.
__device__ __forceinline__ uint32_t swz32(uint32_t off) { return off ^ (((off >> 7) & 1u) << 4); }

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// D(64 x 64, f32) += (NEG ? -A : A)(64 x 16, bf16 registers) B(16 x 64), B
// MN-major in shared memory (descriptor db): sm90_common.cuh's GmmaRS<64>
// with wgmma's immediate scale of A.
#define WF4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WGMMA_RS64(SCALE_A)                                                                   \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                 \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
      "{%32, %33, %34, %35}, %36, p, " SCALE_A ", 1, 1;\n}\n"                                 \
      : WF4(d, 0), WF4(d, 1), WF4(d, 2), WF4(d, 3), WF4(d, 4), WF4(d, 5), WF4(d, 6), WF4(d, 7) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <bool NEG>
__device__ __forceinline__ void gmma_rs64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NEG) {
    WGMMA_RS64("-1");
  } else {
    WGMMA_RS64("1");
  }
}
#undef WGMMA_RS64
#undef WF4

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    winograd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tu,
                    const __grid_constant__ CUtensorMap ty, const WinoParams p) {
  using S = Stage<T>;
  constexpr int ST = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto halo = [&](int s) { return base + s * S::kBytes; };
  auto ubuf = [&](int s) { return base + s * S::kBytes + S::kHaloPad; };
  const uint32_t sE = base + ST * S::kBytes;  // the epilogue's buffer
  const uint32_t bars = sE + S::kEpilogue;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  auto generic = [&](uint32_t a) { return smem_raw + (a - smem_u32(smem_raw)); };

  // Persistent: the cluster walks the units (a pair of 8 x 8-tile patches,
  // one per CTA, x a 64-channel slice of Co) from its index on, a grid's
  // worth of clusters apart; the slices of one patch pair are neighbours,
  // so that the clusters running together share their input patches in L2.
  const uint32_t rank = cluster_ctarank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int units = p.patch_pairs * p.co_tiles;
  auto unit_at = [&](int u, int& n, int& ty0, int& tx0, int& co0) {
    const int patch = (u / p.co_tiles) * kCluster + rank;  // past the last image: all zeros
    co0 = (u % p.co_tiles) * kTN;
    n = patch / p.patches_hw;
    const int rem = patch % p.patches_hw;
    ty0 = (rem / p.patches_w) * kTilesSide;
    tx0 = (rem % p.patches_w) * kTilesSide;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8 * kCluster);  // every consumer warp of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: the halo (own) and half of U (multicast) a step; the
    // warpgroup gives its registers to the consumers ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tu);
      constexpr int kPos = 16 / kCluster;
      constexpr uint16_t kMask = (1u << kCluster) - 1;
      int g = 0;  // steps so far, over the units
      for (int u = cluster; u < units; u += clusters) {
        int n, ty0, tx0, co0;
        unit_at(u, n, ty0, tx0, co0);
        for (int t = 0; t < p.steps; ++t, ++g) {
          const int s = g % ST;
          if (g >= ST) mbar_wait(empty(s), ((g / ST) + 1) & 1);
          mbar_expect_tx(full(s), S::kHaloBytes + kUBytes);
          tma_load_4d(halo(s), &tx, full(s), t * kCK, 2 * tx0 - 1, 2 * ty0 - 1, n);
          tma_load_4d_multicast(ubuf(s) + rank * kPos * kCK * 128, &tu, full(s), kMask, co0,
                                t * kCK, rank * kPos, 0);
        }
      }
    }
    cluster_sync();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup c owns b = 2c, 2c + 1 ----
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tg = lane & 3;
  // accumulator and A-fragment rows: g8 is tile (2 warp, g8), g8 + 8 tile
  // (2 warp + 1, g8) of the patch
  float acc[2][2][8][4];  // R[rp][bb] for b = 2c + bb
  uint32_t af[2][4][4];   // V[a][b] of b = 2c + bb, the A fragments

  // V[a][b] of this step's 16 channels for b = 2c, 2c + 1, in af: warp w's
  // tiles are rows 2w, 2w + 1 of the patch (fragment rows g8, g8 + 8) at
  // column g8, so it reads halo rows 4w .. 4w + 5 at the three patch
  // columns s = c, c + 1, c + 2 that its two b take (B^T's rows: b 0 = s0 -
  // s2, 1 = s1 + s2, 2 = s2 - s1, 3 = s1 - s3), each once: 18 8 x 8
  // matrices of a pixel row x 8 tile columns a channel half (bf16: ldmatrix;
  // fp32: this lane's own values). Then t[k][bb] = (d B)[k][b] along the
  // columns, and V[a] = B^T t along the rows (V0 = t0 - t2, V1 = t1 + t2,
  // V2 = t2 - t1, V3 = t1 - t3 of the tile row's four pixel rows).
  auto transform = [&](auto c_const, int st) {
    constexpr int C = decltype(c_const)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // channels 8 h .. 8 h + 7
      float2 d[18];                // d[3 k + j]: halo row 4w + k, patch column C + j
      if constexpr (sizeof(T) == 2) {
        uint32_t x[18];
        // lane L addresses row L % 8 (tile column) of matrix 4 i + L / 8
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const int q = min(4 * i + (lane >> 3), 17);
          const int k = q / 3, j = q % 3;
          const uint32_t pix = (4 * warp + k) * kHalo + 2 * (lane & 7) + C + j;
          const uint32_t addr = halo(st) + swz32(pix * 32 + 16 * h);
          if (i < 4) {
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(x[4 * i]), "=r"(x[4 * i + 1]), "=r"(x[4 * i + 2]),
                           "=r"(x[4 * i + 3])
                         : "r"(addr));
          } else {
            asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                         : "=r"(x[16]), "=r"(x[17])
                         : "r"(addr));
          }
        }
#pragma unroll
        for (int q = 0; q < 18; ++q) d[q] = unpack_bf16(x[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 18; ++q) {
          const uint32_t pix = (4 * warp + q / 3) * kHalo + 2 * g8 + C + q % 3;
          d[q] = *reinterpret_cast<const float2*>(
              generic(halo(st) + swz64(pix * 64 + (8 * h + 2 * tg) * 4)));
        }
      }
      float2 t[6][2];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float2 d0 = d[3 * k], d1 = d[3 * k + 1], d2 = d[3 * k + 2];
        if constexpr (C == 0) {  // b 0: s0 - s2; b 1: s1 + s2
          t[k][0] = make_float2(d0.x - d2.x, d0.y - d2.y);
          t[k][1] = make_float2(d1.x + d2.x, d1.y + d2.y);
        } else {  // b 2: s2 - s1; b 3: s1 - s3 (s = 1 + j)
          t[k][0] = make_float2(d1.x - d0.x, d1.y - d0.y);
          t[k][1] = make_float2(d0.x - d2.x, d0.y - d2.y);
        }
      }
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
#pragma unroll
        for (int m = 0; m < 2; ++m) {  // tile row 2w + m: pixel rows 2m .. 2m + 3
          const float2 t0 = t[2 * m][bb], t1 = t[2 * m + 1][bb], t2 = t[2 * m + 2][bb],
                       t3 = t[2 * m + 3][bb];
          af[bb][0][2 * h + m] = pack_bf16(t0.x - t2.x, t0.y - t2.y);
          af[bb][1][2 * h + m] = pack_bf16(t1.x + t2.x, t1.y + t2.y);
          af[bb][2][2 * h + m] = pack_bf16(t2.x - t1.x, t2.y - t1.y);
          af[bb][3][2 * h + m] = pack_bf16(t1.x - t3.x, t1.y - t3.y);
        }
    }
    gmma_fence_regs(af[0]);
    gmma_fence_regs(af[1]);
  };
  // R[rp][b] += sum_a A^T[rp][a] V[a][b] U[a][b]: A^T = [1 1 1 0; 0 1 -1 -1]
  auto products = [&](int st, int bb) {
    const int b = 2 * c + bb;
    auto desc = [&](int a) { return gmma_desc(ubuf(st) + (a * 4 + b) * kCK * 128, 1024, 1024); };
    gmma_fence();
    gmma_rs64<false>(acc[0][bb], af[bb][0], desc(0));
    gmma_rs64<false>(acc[0][bb], af[bb][1], desc(1));
    gmma_rs64<false>(acc[0][bb], af[bb][2], desc(2));
    gmma_rs64<false>(acc[1][bb], af[bb][1], desc(1));
    gmma_rs64<true>(acc[1][bb], af[bb][2], desc(2));
    gmma_rs64<true>(acc[1][bb], af[bb][3], desc(3));
    gmma_commit();
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(empty(st), r);
  };
  auto sync_consumers = [&]() { named_sync(kBarExchange, kConsumerThreads); };
  float4* xbuf = reinterpret_cast<float4*>(generic(sE)) + tid;
  const bool storer = threadIdx.x == 0;

  // The unit's output: warpgroup C (a compile-time copy of c, so that the
  // accumulators are indexed by constants) finishes row parity C.
  auto epilogue = [&](auto c_const, int n, int ty0, int tx0, int co0) {
    constexpr int C = decltype(c_const)::value;
      // Y[rp][cp] = sum_b R[rp][b] A[b][cp], A^T = [1 1 1 0; 0 1 -1 -1]:
      // this warpgroup's share in acc[rp][cp] ...
#pragma unroll
      for (int rp = 0; rp < 2; ++rp)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float r0 = acc[rp][0][i][e], r1 = acc[rp][1][i][e];
            acc[rp][0][i][e] = C == 0 ? r0 + r1 : r0;   // b 0, 1: R0 + R1; b 2, 3: R2
            acc[rp][1][i][e] = C == 0 ? r1 : -r0 - r1;  // b 0, 1: R1; b 2, 3: -R2 - R3
          }
      // ... then the other's, through shared memory, one column parity at a
      // time: warpgroup c finishes row parity c. The buffer's last reader was
      // the previous unit's store (the storer waited for it).
      if (storer) tma_store_wait_read();
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        sync_consumers();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xbuf[(C * 8 + i) * 128] = make_float4(acc[1 - C][cp][i][0], acc[1 - C][cp][i][1],
                                                acc[1 - C][cp][i][2], acc[1 - C][cp][i][3]);
        }
        sync_consumers();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 o = xbuf[((1 - C) * 8 + i) * 128];
          acc[C][cp][i][0] += o.x;
          acc[C][cp][i][1] += o.y;
          acc[C][cp][i][2] += o.z;
          acc[C][cp][i][3] += o.w;
        }
      }
      sync_consumers();
      // the bias, then the 16 x 16-pixel output tile in shared memory as the
      // output map's box (bf16: pixel rows of 128 bytes, 128-byte swizzle;
      // fp32: rows of 256 bytes), and one TMA store (nothing past the image,
      // the batch or Co is written)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * tg;
        const float b0 = p.bias && co0 + col < p.Co ? p.bias[co0 + col] : 0.f;
        const float b1 = p.bias && co0 + col + 1 < p.Co ? p.bias[co0 + col + 1] : 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            const int py = 2 * (2 * warp + hr) + C, px = 2 * g8 + cp;
            const int pix = py * 16 + px;
            const float v0 = acc[C][cp][i][2 * hr] + b0, v1 = acc[C][cp][i][2 * hr + 1] + b1;
            if constexpr (sizeof(T) == 2) {
              const uint32_t at = sE + pix * 128 + ((i ^ (pix & 7)) << 4) + 4 * tg;
              *reinterpret_cast<uint32_t*>(generic(at)) = pack_bf16(v0, v1);
            } else {
              *reinterpret_cast<float2*>(generic(sE + pix * 256 + col * 4)) = make_float2(v0, v1);
            }
          }
      }
      fence_proxy_async();
      sync_consumers();
      if (storer) tma_store_4d(&ty, sE, co0, 2 * tx0, 2 * ty0, n);
  };

  int g = 0;  // steps so far, over the units
  for (int u = cluster; u < units; u += clusters) {
    int n, ty0, tx0, co0;
    unit_at(u, n, ty0, tx0, co0);
#pragma unroll
    for (int rp = 0; rp < 2; ++rp)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[rp][bb][i][0] = acc[rp][bb][i][1] = acc[rp][bb][i][2] = acc[rp][bb][i][3] = 0.f;
    for (int t = 0; t < p.steps; ++t, ++g) {
      const int st = g % ST;
      mbar_wait(full(st), (g / ST) & 1);
      // step t - 1's products are done: its fragments and its stage are free
      if (t > 0) {
        gmma_wait<0>();
        release((g - 1) % ST);
      }
      if (c == 0)
        transform(std::integral_constant<int, 0>(), st);
      else
        transform(std::integral_constant<int, 1>(), st);
      products(st, 0);
      products(st, 1);
    }
    gmma_wait<0>();
    release((g - 1) % ST);
#pragma unroll
    for (int rp = 0; rp < 2; ++rp)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) gmma_fence_regs(acc[rp][bb]);

    if (c == 0)
      epilogue(std::integral_constant<int, 0>(), n, ty0, tx0, co0);
    else
      epilogue(std::integral_constant<int, 1>(), n, ty0, tx0, co0);
  }
  if (storer) tma_store_wait();
  cluster_sync();  // no peer multicasts into or arrives on this block after it exits
}

// ---- host ----

template <typename T>
int launch(const void* x, const void* u, void* y, const long long* maps, const WinoParams& p,
           unsigned grid_x, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const CUtensorMapDataType type = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tu, ty;
  const cuuint32_t boxes[3][4] = {{kCK, kHalo, kHalo, 1},
                                  {kTN, kCK, 16 / kCluster, 1},
                                  {kTN, 2 * kTilesSide, 2 * kTilesSide, 1}};
  const CUtensorMapSwizzle swizzles[3] = {
      F32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_128B,
      F32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B};
  CUtensorMap* out[3] = {&tx, &tu, &ty};
  const void* ptrs[3] = {x, u, y};
  for (int i = 0; i < 3; ++i) {
    const long long* m = maps + 7 * i;
    const cuuint64_t dims[4] = {(cuuint64_t)m[0], (cuuint64_t)m[1], (cuuint64_t)m[2],
                                (cuuint64_t)m[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)m[4], (cuuint64_t)m[5], (cuuint64_t)m[6]};
    if (!encode_tiled(out[i], i == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : type, 4, ptrs[i], dims,
                      strides, boxes[i], swizzles[i]))
      return (int)cudaErrorInvalidValue;
  }
  auto kern = winograd_kernel<T>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, Stage<T>::kSmem, configured);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_x, kThreads, Stage<T>::kSmem, stream>>>(tx, tu, ty, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) bf16 (dtype 0) or fp32 (1), 16-byte aligned, C a multiple
// of 16 (the wrapper appends zero channels to other C); u (16, C, Co) bf16;
// bias (Co) fp32 or null; y (N, H, W, Co) in x's type; Co a multiple of 8
// (the wrapper pads U, the bias and y for other Co). H and W even. `maps`:
// the x, u and y tensor maps of ops/winograd.py's winograd_plan, 7 values
// each (4 extents, innermost first, then the byte strides of axes 1-3);
// grid_x: CTAs, a multiple of the cluster, each walking units (a patch of
// 8 x 8 tiles x 64 output channels) a grid apart.
extern "C" int hallo_winograd_conv3x3(const void* x, const void* u, const void* bias, void* y,
                                      const long long* maps, int N, int H, int W, int C, int Co,
                                      int dtype, int grid_x, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || C % kCK || Co <= 0 || Co % 8 ||
      (dtype != 0 && dtype != 1) || grid_x <= 0 || grid_x % kCluster)
    return (int)cudaErrorInvalidValue;
  // the maps' extents must be the shapes'
  const long long want[3][4] = {{C, W, H, N}, {Co, C, 16, 1}, {Co, W, H, N}};
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 4; ++a)
      if (maps[7 * i + a] != want[i][a]) return (int)cudaErrorInvalidValue;
  WinoParams p;
  p.bias = static_cast<const float*>(bias);
  p.Co = Co;
  p.tiles_h = H / 2;
  p.tiles_w = W / 2;
  p.patches_w = (p.tiles_w + kTilesSide - 1) / kTilesSide;
  const long long patches_hw = (long long)p.patches_w * ((p.tiles_h + kTilesSide - 1) / kTilesSide);
  const long long pairs = (N * patches_hw + kCluster - 1) / kCluster;
  p.co_tiles = (Co + kTN - 1) / kTN;
  if (pairs * p.co_tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  p.patches_hw = (int)patches_hw;
  p.patch_pairs = (int)pairs;
  p.steps = C / kCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<bf16>(x, u, y, maps, p, (unsigned)grid_x, s)
                    : launch<float>(x, u, y, maps, p, (unsigned)grid_x, s);
}
