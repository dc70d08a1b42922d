// K3 for Hopper (sm_90a): the heads-major flash-attention forward on fp32
// or bf16 I/O, with a TMA ring, a conversion stage and wgmma products.
//
// Replaces hallo_tpu/ops/pallas_flash.py:120 `_attention_kernel_t` (reached
// through `_flash_forward_t`, :787, from `flash_attention` when d % 128 !=
// 0): on the main path the wav2vec2 self-attention, 12 heads of d 64, fp32
// q, k, v through the model's (B, T, H, d) -> (B, H, T, d) view, at L 304
// (12 s of audio) to 1056 (42 s). It takes any (batch, token, head) strides
// with d contiguous and 16-byte steps, d a multiple of 8 up to 160, an
// optional fp32 per-key bias (B, Lk) in natural-log units, Lk from 1 up,
// and writes o (B, H, Lq, d) in the input's type. The TPU's transposed
// scores were an MXU layout choice and are not carried over.
//
// What bounds it on this card: at L 304 the call moves 0.37 MB (1.1 us at
// 3.35 TB/s) and does 0.28 GFLOP, so one launch's fixed latency -- the first
// TMA round trip, the pipeline's fill and drain, the host -- sets the
// floor; at L 1056, 1.3 MB and 3.4 GFLOP (3.5 us at the bf16 peak), still
// latency and waves more than the tensor cores.
//
// Design: K1's (flash_fwd_sm90.cu) consumers behind a conversion stage.
// - fp32 -> bf16 (`__float2bfloat16_rn`: the TPU MXU's default precision for
//   fp32, as the first CUDA port of this kernel did) happens between the
//   ring and the products.
//   Of the two ways -- converting into bf16 swizzled tiles for wgmma, or
//   converting mma.sync fragments in registers as K2 does -- this kernel
//   takes the first: the consumers are then K1's, proven on this card
//   (wgmma SS for S, RS for PV with P in registers, turns on named
//   barriers), and the conversion runs in warps of its own, overlapped with
//   the products; with mma.sync every consumer would convert every K and V
//   fragment it reads (V's transposed fragments not even by ldmatrix), on
//   the warps that also run the softmax. Measured on an H100 (PERF.md §6):
//   the conversion costs a quarter of the kernel's time at L 1056 (an
//   ablation that skips it, its results wrong, ran 0.023 ms against 0.031),
//   which bounds what the mma.sync way could gain; it was not built. Each
//   converter thread issues the loads of 4 chunks before it converts any
//   (one chunk at a time took 0.041 ms).
// - The producer warpgroup: warp 0's first lane keeps a ring of 2-4 slots of
//   fp32 (or bf16) K and V tiles in flight by TMA (a 4-d map per operand over
//   the (B, L, H, d) view: (d, L, H, B) per head, or (H d, L, 1, B) when a
//   token's heads are adjacent, which keeps every 128-byte box row inside
//   the map: TMA fills a box past the innermost extent slowly); warps 1-3
//   convert each landed slot into the K or the V ring of bf16 128-byte-
//   swizzled tiles, 2 stages each, with zeros past d (so no value of another
//   head, not even an inf, reaches a product), and with K's tile they write
//   its bias tile (bias times log2 e, -inf past Lk). Every converter warp
//   waits on every phase of every slot and stage, as every consumer warp
//   does.
// - The consumers: 2 warpgroups of 64 query rows, or 3 up to d 64 where 2
//   would take more waves of one CTA an SM (ops/flash.py: _consumers). Each
//   reads its Q rows from global memory once, rounds them to bf16 into its
//   own swizzled tile, then runs K1's loop: S_t = Q K_t^T (m64nBNk16) and
//   O += P_{t-1} V_{t-1} (m64nDk16, V MN-major) in one turn, the base-2
//   online softmax (flash_common.cuh: tile_softmax) while PV runs; K_t is
//   released after its softmax, V_t after its product.
// - The grid: (query blocks, H, B), one CTA an SM (shared memory). At L 304,
//   3 blocks of 128 rows a head, 36 CTAs; at L 1056, 9, 108 CTAs (3 blocks
//   of 192 rows were 11-15% slower there); at L 4096, 22 blocks of 192, 264
//   CTAs, two waves (384 CTAs of 128 rows took 30% longer). The
//   widths are instantiated at d rounded up to 32 (the pad columns are the
//   converter's zeros); keys past Lk score -inf; a row whose keys are all
//   masked gives 0; query rows past Lq are computed on zeros, not stored.
//
// The host encodes the two tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint) and passes them as __grid_constant__
// parameters; every other launch integer comes in one array that the
// wrapper caches by shape (ops/flash.py: heads_major_plan).

#include <cuda.h>

#include <chrono>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kSmemMax = 232448;
constexpr int kBarSched = 1;  // named barriers 1 .. consumers: the turns
constexpr int kConverterWarps = 3;
constexpr int kConvUnroll = 4;  // chunks a converter thread loads before it converts

// NC consumer warpgroups: 2 or, up to d 64, 3 (ops/flash.py chooses: the
// fewer rows a CTA, the more CTAs, unless that takes another wave)
template <typename T, int DP, int NC>
struct Tiles {
  static_assert(NC == 2 || (NC == 3 && DP <= 64), "consumer warpgroups");
  static constexpr int kConsumers = NC;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kBlockK = DP <= 64 ? 128 : 64;
  // registers a thread after setmaxnreg. ptxas compiles the consumers for
  // what the block gets at launch (128 a thread at 512 threads, 168 at 384)
  // whatever setmaxnreg grants later, so the consumers gain nothing past that
  // and the converters, whose unrolled loads need more than 24, take the
  // rest. The sum may not exceed the launch's (65536 or 64512): a consumer's
  // `setmaxnreg.inc` past it waits forever.
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 152 : 224;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    (kConsumers == 3 ? 65536 : 64512),
                "registers");
  static constexpr int kBoxes = (DP + 63) / 64;  // bf16 64-column boxes along d
  static constexpr int kBox = kBlockK * 128;     // bytes of one bf16 box of a K/V tile
  static constexpr int kTile = kBoxes * kBox;    // a bf16 K (or V) tile
  static constexpr int kQBox = kBlockQ * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kCols = 128 / (int)sizeof(T);  // columns a source box row holds
  static constexpr int kSrcBoxes = (DP + kCols - 1) / kCols;
  static constexpr int kSlot = kSrcBoxes * kBlockK * 128;  // a landed K or V tile
  static constexpr int kBiasBytes = kBlockK * 4;
  static constexpr int kFixed = kQBytes + 4 * kTile + 2 * kBiasBytes + 1024 + 256;
  static constexpr int kSlots = (kSmemMax - kFixed) / kSlot > 4 ? 4 : (kSmemMax - kFixed) / kSlot;
  // barriers: per slot full, empty; per bf16 stage K full, K empty, V full,
  // V empty
  static constexpr int kBarriers = 2 * kSlots + 8;
  static constexpr int kSmem = kQBytes + 4 * kTile + 2 * kBiasBytes + kSlots * kSlot +
                               8 * kBarriers + 1024;
  static_assert(kSlots >= 2 && kSmem <= kSmemMax, "shared memory");
};

struct TParams {
  const void* q;
  const float* bias;  // (B, Lk) fp32, natural-log units, or nullptr
  void* o;
  int H, Lq, Lk, D;
  long long q_sb, q_sl, q_sh;
  long long o_sb, o_sl, o_sh;
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
  int wide;          // the maps span a token's H d columns
};

// 8 consecutive values as 16 bytes of bf16
template <typename T>
__device__ __forceinline__ uint4 to_bf16x8(const T* p);

template <>
__device__ __forceinline__ uint4 to_bf16x8<float>(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}

template <>
__device__ __forceinline__ uint4 to_bf16x8<bf16>(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st_shared_v4(uint32_t at, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(x.x), "r"(x.y),
               "r"(x.z), "r"(x.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t at) {
  uint4 x;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(at)
               : "memory");
  return x;
}

// The 16-byte chunk holding columns col .. col + 7 of row r of a
// 128-byte-swizzled tile of boxes `box` bytes apart (1024-byte aligned).
__device__ __forceinline__ uint32_t swz_chunk(uint32_t base, int box, int r, int byte) {
  return base + (byte >> 7) * box + r * 128 + ((((byte >> 4) & 7) ^ (r & 7)) << 4);
}

template <typename T, int DP, int NC>
__global__ void __launch_bounds__(Tiles<T, DP, NC>::kThreads, 1)
    flash_fwd_t_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const TParams p) {
  using C = Tiles<T, DP, NC>;
  constexpr int BN = C::kBlockK, NS = C::kSlots;
  constexpr int KT = BN / 8, DT = DP / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;          // 2 bf16 K stages
  const uint32_t sV = sK + 2 * C::kTile;        // 2 bf16 V stages
  const uint32_t sSlot = sV + 2 * C::kTile;     // the landed fp32 (or bf16) tiles
  const uint32_t sB = sSlot + NS * C::kSlot;    // 2 bias tiles, with K's stages
  const uint32_t bars = sB + 2 * C::kBiasBytes;
  auto slot_full = [&](int s) { return bars + 8 * s; };
  auto slot_empty = [&](int s) { return bars + 8 * (NS + s); };
  auto k_full = [&](int s) { return bars + 8 * (2 * NS + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 * NS + 2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 * NS + 4 + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 * NS + 6 + s); };

  const int b = blockIdx.z, h = blockIdx.y;
  constexpr int kConsumers = C::kConsumers;
  const int q0 = blockIdx.x * C::kBlockQ;
  const int nkv = (p.Lk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(slot_full(s), 1);
      mbar_init(slot_empty(s), kConverterWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), kConverterWarps);
      mbar_init(v_full(s), kConverterWarps);
      mbar_init(k_empty(s), 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // box j of head h: column j kCols of the head's own map, or of a wide map
  // over the token's H d columns from h d
  const int col = p.wide ? h * p.D : 0, head = p.wide ? 0 : h;
  if (wg == 0) {
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 0) {
      // ---- the TMA thread: K_0, V_0, K_1, ... into the slots ----
      if (lane == 0) {
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        for (int n = 0; n < 2 * nkv; ++n) {
          const int s = n % NS;
          if (n >= NS) mbar_wait(slot_empty(s), ((n / NS) + 1) & 1);
          mbar_expect_tx(slot_full(s), C::kSlot);
          const CUtensorMap* map = (n & 1) ? &tv : &tk;
          for (int j = 0; j < C::kSrcBoxes; ++j)
            tma_load_4d(sSlot + s * C::kSlot + j * BN * 128, map, slot_full(s),
                        col + j * C::kCols, (n >> 1) * BN, head, b);
        }
      }
    } else {
      // ---- converters: each landed slot -> its bf16 stage, zeros past d ----
      const int cid = tid - 32;  // 0 .. 95
      const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
      const float* bias_tiles = reinterpret_cast<const float*>(smem_raw + (sB - raw));
      for (int n = 0; n < 2 * nkv; ++n) {
        const int s = n % NS, t = n >> 1, st = t & 1;
        const bool is_v = n & 1;
        mbar_wait(slot_full(s), (n / NS) & 1);
        if (t >= 2) mbar_wait(is_v ? v_empty(st) : k_empty(st), ((t >> 1) + 1) & 1);
        const uint32_t src = sSlot + s * C::kSlot;
        const uint32_t dst = (is_v ? sV : sK) + st * C::kTile;
        // kConvUnroll 8-column chunks a thread a step, their shared-memory
        // loads issued before any conversion (the asm is volatile: the order
        // written is the order issued)
        constexpr int kChunks = BN * C::kBoxes * 8, kStep = 32 * kConverterWarps;
        for (int i0 = cid; i0 < kChunks; i0 += kConvUnroll * kStep) {
          uint4 a[kConvUnroll], c[kConvUnroll];
#pragma unroll
          for (int u = 0; u < kConvUnroll; ++u) {
            const int i = i0 + u * kStep;
            const int r = i / (C::kBoxes * 8), c8 = (i % (C::kBoxes * 8)) * 8;  // 8 columns
            a[u] = c[u] = make_uint4(0u, 0u, 0u, 0u);
            if (i < kChunks && c8 < p.D) {
              const int byte = c8 * (int)sizeof(T);
              a[u] = ld_shared_v4(swz_chunk(src, BN * 128, r, byte));
              if constexpr (sizeof(T) == 4)
                c[u] = ld_shared_v4(swz_chunk(src, BN * 128, r, byte + 16));
            }
          }
#pragma unroll
          for (int u = 0; u < kConvUnroll; ++u) {
            const int i = i0 + u * kStep;
            const int r = i / (C::kBoxes * 8), c8 = (i % (C::kBoxes * 8)) * 8;
            uint4 x = a[u];
            if constexpr (sizeof(T) == 4)
              x = make_uint4(pack_bf16(__uint_as_float(a[u].x), __uint_as_float(a[u].y)),
                             pack_bf16(__uint_as_float(a[u].z), __uint_as_float(a[u].w)),
                             pack_bf16(__uint_as_float(c[u].x), __uint_as_float(c[u].y)),
                             pack_bf16(__uint_as_float(c[u].z), __uint_as_float(c[u].w)));
            if (i < kChunks) st_shared_v4(swz_chunk(dst, BN * 128, r, c8 * 2), x);
          }
        }
        if (!is_v && bias) {
          float* bt = const_cast<float*>(bias_tiles) + st * BN;
          for (int i = cid; i < BN; i += 32 * kConverterWarps) {
            const int key = t * BN + i;
            bt[i] = key < p.Lk ? bias[key] * kLog2e : -INFINITY;
          }
        }
        fence_proxy_async();  // the bf16 tile is read by wgmma (the async proxy)
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(slot_empty(s));
          mbar_arrive(is_v ? v_full(st) : k_full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = wg - 1;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
    const float* bias_tiles =
        p.bias ? reinterpret_cast<const float*>(smem_raw + (sB - raw)) : nullptr;
    const uint32_t qa = sQ + cw * 64 * 128;

    // Q: this warpgroup's 64 rows from global memory, rounded to bf16 once
    {
      const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
      for (int i = tid; i < 64 * C::kBoxes * 8; i += 128) {
        const int r = i / (C::kBoxes * 8), c8 = (i % (C::kBoxes * 8)) * 8;
        const int row = q0 + cw * 64 + r;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (row < p.Lq && c8 < p.D) x = to_bf16x8<T>(qb + row * p.q_sl + c8);
        st_shared_v4(swz_chunk(qa, C::kQBox, r, c8 * 2), x);
      }
      fence_proxy_async();
      named_sync(kBarSched + kConsumers + cw, 128);
    }

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    float sc[KT][4];          // scores of tile t, then its probabilities
    uint32_t pf[BN / 16][4];  // tile t - 1's probabilities, bf16: PV's A operand

    auto issue_s = [&](int s) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32u;
        const uint64_t da = gmma_desc(qa + (ks / 4) * C::kQBox + off, 16, 1024);
        const uint64_t db = gmma_desc(sK + s * C::kTile + (ks / 4) * C::kBox + off, 16, 1024);
        GmmaSS<BN>::run(sc, da, db, ks > 0 ? 1u : 0u);
      }
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        GmmaRS<DP>::run(acc, pf[kk], gmma_desc(sV + s * C::kTile + kk * 2048, C::kBox, 1024));
    };
    auto softmax_tile = [&](int t, float (&alpha)[2]) {
      const float* bias = bias_tiles ? bias_tiles + (t & 1) * BN : nullptr;
      tile_softmax(sc, m_r, l_r, alpha, p.scale_log2, bias, t * BN, p.Lk, tg);
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

    // tile 0: S_0 only
    mbar_wait(k_full(0), 0);
    turn_begin();
    issue_s(0);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(sc);
    {
      float alpha[2];
      softmax_tile(0, alpha);  // the output is still 0: nothing to rescale
    }
    release(k_empty(0));  // K_0 and its bias tile
    pack_p();

    // tile t: S_t with O += P_{t-1} V_{t-1} in one turn, then S_t's softmax
    // while the PV product runs
    for (int t = 1; t < nkv; ++t) {
      const int s = t & 1, sp = (t - 1) & 1;
      mbar_wait(k_full(s), (t >> 1) & 1);
      mbar_wait(v_full(sp), ((t - 1) >> 1) & 1);
      turn_begin();
      issue_s(s);
      gmma_commit();
      issue_pv(sp);
      gmma_commit();
      turn_end();
      gmma_wait<1>();
      gmma_fence_regs(sc);
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
    const int sl = (nkv - 1) & 1;
    mbar_wait(v_full(sl), ((nkv - 1) >> 1) & 1);
    turn_begin();
    issue_pv(sl);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(acc);
    if (cw == 0) named_sync(kBarSched + 0, 2 * 128);  // the last hand-over

    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
    store_rows<T, DT>(ob, p.o_sl, acc, l_r, row0, p.Lq, 0, p.D, tg);
  }
}

// ---- host ----

// The launch array (ops/flash.py: heads_major_plan's `args`).
enum Arg {
  kB, kH, kLq, kLk, kD, kDP, kDtype,  // dtype: 0 bf16, 1 fp32 (q, k, v, o)
  kWide,
  kQsb, kQsl, kQsh, kOsb, kOsl, kOsh, kBiasSb,
  kMaps,  // k then v: 4 extents and 3 byte strides each (14 values)
  kBlockQ = kMaps + 14, kBlockK, kSlotsArg,
  kArgs
};

// One operand's map: 4 extents (innermost first), the byte strides of axes
// 1-3, a box of 128 bytes x block_k rows, 128-byte swizzle.
bool encode_src(CUtensorMap* map, const void* ptr, const long long* m, int cols, int block_k,
                bool f32) {
  const cuuint64_t dims[4] = {(cuuint64_t)m[0], (cuuint64_t)m[1], (cuuint64_t)m[2],
                              (cuuint64_t)m[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)m[4], (cuuint64_t)m[5], (cuuint64_t)m[6]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)block_k, 1, 1};
  return encode_tiled(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename T, int DP, int NC>
cudaError_t launch(const void* k, const void* v, const long long* a, const TParams& p,
                   cudaStream_t stream) {
  using C = Tiles<T, DP, NC>;
  if (a[kBlockQ] != C::kBlockQ || a[kBlockK] != C::kBlockK || a[kSlotsArg] != C::kSlots)
    return cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  constexpr bool f32 = sizeof(T) == 4;
  if (!encode_src(&tk, k, a + kMaps, C::kCols, C::kBlockK, f32) ||
      !encode_src(&tv, v, a + kMaps + 7, C::kCols, C::kBlockK, f32))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_t_sm90_kernel<T, DP, NC>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, C::kSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + C::kBlockQ - 1) / C::kBlockQ, p.H, (int)a[kB]);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(tk, tv, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* k, const void* v, const long long* a, const TParams& p,
                     cudaStream_t st) {
  const bool three = a[kBlockQ] == 192;  // else 2 consumer warpgroups (checked at launch)
  switch (a[kDP]) {
    case 32: return three ? launch<T, 32, 3>(k, v, a, p, st) : launch<T, 32, 2>(k, v, a, p, st);
    case 64: return three ? launch<T, 64, 3>(k, v, a, p, st) : launch<T, 64, 2>(k, v, a, p, st);
    case 96: return launch<T, 96, 2>(k, v, a, p, st);
    case 128: return launch<T, 128, 2>(k, v, a, p, st);
    case 160: return launch<T, 160, 2>(k, v, a, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v (bf16 or fp32, `args`' dtype) through (batch, token, head)
// strides, d contiguous; `args` (ops/flash.py: heads_major_plan) holds every
// launch integer, the k and v maps among them.
extern "C" int hallo_flash_fwd_t_sm90(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, const long long* args,
                                      float scale_log2, void* stream) {
  const long long* a = args;
  if (a[kB] <= 0 || a[kH] <= 0 || a[kLq] <= 0 || a[kLk] <= 0 || a[kD] <= 0 || a[kD] % 8 ||
      a[kD] > 160 || a[kDP] != (a[kD] + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  TParams p;
  p.q = q;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.H = (int)a[kH]; p.Lq = (int)a[kLq]; p.Lk = (int)a[kLk]; p.D = (int)a[kD];
  p.q_sb = a[kQsb]; p.q_sl = a[kQsl]; p.q_sh = a[kQsh];
  p.o_sb = a[kOsb]; p.o_sl = a[kOsl]; p.o_sh = a[kOsh];
  p.bias_sb = a[kBiasSb];
  p.scale_log2 = scale_log2;
  p.wide = (int)a[kWide];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a[kDtype] == 0) return (int)dispatch<bf16>(k, v, a, p, st);
  if (a[kDtype] == 1) return (int)dispatch<float>(k, v, a, p, st);
  return (int)cudaErrorInvalidValue;
}

// Host nanoseconds of `iters` encodings of a call's two tensor maps (the
// per-call host work they add), or -1 if one fails.
extern "C" int hallo_flash_fwd_t_encode_ns(const void* k, const void* v, const long long* args,
                                           int iters) {
  const bool f32 = args[kDtype] == 1;
  const int cols = f32 ? 32 : 64;
  CUtensorMap tk, tv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_src(&tk, k, args + kMaps, cols, (int)args[kBlockK], f32) ||
        !encode_src(&tv, v, args + kMaps + 7, cols, (int)args[kBlockK], f32))
      return -1;
  return (int)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}
