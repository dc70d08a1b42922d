// K4 for Hopper (sm_90a): the heads-major flash-attention forward at wide
// heads (d a multiple of 128 up to 512: the VAE mid-block's single head of
// d 512), with TMA loads, wgmma products and a producer warp beside two
// consumer warpgroups.
//
// Replaces hallo_tpu/ops/pallas_flash.py:73 `_attention_kernel` (launched at
// :1019 through `flash_attention`, :1079): attention on (B, H, L, d) bf16
// q, k, v read through their own (batch, token, head) strides, an optional
// fp32 per-key bias (B, Lk) in natural-log units, applied in the exp2
// domain; a row whose keys are all masked gives 0. The output is normalised
// and stored in bf16 or fp32 (`out_f32`: the wrapper rounds fp32 inputs to
// bf16 first, as the tensor cores take them); softmax and accumulation are
// fp32.
//
// What bounds it on this card: at the main path's shape (one head, Lq = Lk
// = 4096, d 512, B 3 for the VAE encode and 16 for the decode) the two
// products, 4 Lq Lk d operations, take 0.104 ms at B 3 at 989 TFLOP/s;
// the bytes (q, k, v, o once: 50 MB) 0.015 ms. But the output of 64 query
// rows at d 512 fills half the register file, so a block holds 64 rows and
// reads all of K and V, and its products re-read Q from shared memory every
// 32-key tile: about 192 KB of shared-memory traffic (TMA writes of K and
// V, wgmma reads of Q, K and V) for each tile's 4.2 MFLOP, more than the
// tensor cores take in the same time. Shared memory, the two-stage ring (a
// tile of K and V is 64 KB) and 1.45 waves of CTAs at B 3 hold it at about
// a quarter of the bound (PERF.md).
//
// Design:
// - Block: 64 query rows of one (batch, head); two consumer warpgroups and
//   a producer warpgroup (one thread issues TMA; the warpgroup gives its
//   registers to the consumers with setmaxnreg). Each consumer owns d / 2
//   output columns (128 registers a thread at d 512).
// - S = Q K^T over all of d: each consumer contracts its own half of d (SS
//   wgmma, m64nBNk16, both operands K-major) and the two halves are summed
//   through shared memory (a float4 a thread and 8-key chunk, a named
//   barrier over both warpgroups, then a release barrier a turn later), so
//   both hold the same S and run the same softmax (K1's base-2 online
//   softmax, flash_common.cuh: tile_softmax). Each then runs O += P V for
//   its columns (RS wgmma, P from registers, V MN-major).
// - TMA: one 5-d map per operand, (64 columns, L, d / 64 column blocks, H,
//   B), 128-byte swizzle, so that one box brings a whole tile as d / 64
//   buffers of 64 columns (one TMA a tile, not one a 64-column box); Q (64
//   rows x d, 64 KB at d 512) stays resident; K and V go through rings of
//   `stages` tiles of 32 keys with full barriers (TMA bytes) and empty
//   barriers (one arrival per consumer warp of every CTA of the cluster).
//   Each CTA of a cluster of kCluster loads 1 / kCluster of every K and V
//   tile's column blocks and multicasts them to all, dividing the L2
//   traffic.
//   Query rows past Lq and keys past Lk read as 0 (keys masked to -inf by
//   the softmax, or by the tiled bias, ops/flash.py: _tile_bias).
// - Pipelining: a turn issues S_t and O += P_{t-1} V_{t-1} together; S_t's
//   exchange and softmax run while P_{t-1} V_{t-1} is in flight. The output
//   is rescaled only when a row's running max moved (warp-uniform test).
//
// The host encodes the three tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, no -lcuda) and passes them as
// __grid_constant__ parameters; the maps and tiles come from the wrapper
// (ops/flash.py: d512_plan) and are checked here against the instantiation.

#include <cuda.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kCluster = 2;  // CTAs that share each K/V tile (multicast)
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kConsumerThreads = 256;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 fits the SM's
// 65536 (ptxas gives a 384-thread block 168 at launch)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;            // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
// named barriers: the exchange of S over both consumers, then one per
// consumer's exchange buffer (free again once the other one has read it)
constexpr int kBarExchange = 1;
constexpr int kBarFree = 2;
constexpr int kSmemLimit = 232448;

struct D512Params {
  const float* bias;  // (B, bias_sb) fp32 or nullptr: ops/flash.py: _tile_bias
  void* o;
  int H, Lq, Lk, D;
  long long o_sb, o_sl, o_sh;  // elements
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
  int out_f32;
};

template <int D>
struct Tiles {
  static constexpr int kBoxes = D / 64;      // 64-column boxes along d
  static constexpr int kHalf = D / 2;        // a consumer's columns of S's contraction and of O
  static constexpr int kChunk = kHalf % 128 == 0 ? 128 : 64;  // O's columns a wgmma
  static constexpr int kChunks = kHalf / kChunk;
  static constexpr int kQBox = kBlockQ * 128;
  static constexpr int kKVBox = kBlockK * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one stage of K (or of V)
  static constexpr int kXBytes = 2 * (kBlockK / 8) * 128 * 16;  // S halves, one a consumer
  static constexpr int kBiasBytes = kBlockK * 4;
  // the ring's depth, as ops/flash.py's D512_STAGES: as many K/V tiles as
  // fit beside Q and the exchange, at most 4
  static constexpr int kStages = D == 512 ? 2 : D == 384 ? 3 : 4;
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmem =
      kQBytes + kStages * (2 * kKVBytes + kBiasBytes) + kXBytes + 8 * kBarriers + 1024;
  static_assert(D % 128 == 0 && kSmem <= kSmemLimit, "tiles");
  static_assert(kStages == 4 || kSmem + 2 * kKVBytes + kBiasBytes + 8 * 4 > kSmemLimit,
                "a deeper ring fits");
};

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const D512Params p) {
  using T = Tiles<D>;
  constexpr int BN = kBlockK, NB = T::kBoxes, ST = T::kStages;
  constexpr int KT = BN / 8, CW = T::kChunk, NC = T::kChunks;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;
  const uint32_t sV = sK + ST * T::kKVBytes;
  const uint32_t sX = sV + ST * T::kKVBytes;  // the two consumers' halves of S
  const uint32_t sB = sX + T::kXBytes;        // per stage: the tile's key bias
  // barriers: Q full; per stage K full, V full, K empty, V empty
  const uint32_t bars = sB + ST * T::kBiasBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };
  auto generic = [&](uint32_t a) { return smem_raw + (a - smem_u32(smem_raw)); };

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int nkv = (p.Lk + BN - 1) / BN;
  const uint32_t rank = cluster_ctarank();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      // one arrival per consumer warp of every CTA of the cluster
      mbar_init(k_empty(s), 8 * kCluster);
      mbar_init(v_empty(s), 8 * kCluster);
    }
    mbar_init_fence();
  }
  // the peers' barriers are initialised before any multicast or remote arrival
  cluster_sync();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: one thread keeps the rings full; the warpgroup gives
    // its registers to the consumers ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      // one box a tile and operand: all of its 64-column blocks (the maps'
      // third axis), each landing as its own 128-byte-swizzled buffer
      mbar_expect_tx(q_full, T::kQBytes);
      tma_load_5d(sQ, &tq, q_full, 0, q0, 0, h, b);
      const float* bias_row = p.bias ? p.bias + b * p.bias_sb : nullptr;
      // this CTA's share of a tile: column blocks [rank, rank + 1) x NB /
      // kCluster, multicast to the cluster
      constexpr int kPart = NB / kCluster;
      constexpr uint16_t kMask = (1u << kCluster) - 1;
      const int block = rank * kPart;
      const uint32_t part = block * T::kKVBox;
      for (int t = 0; t < nkv; ++t) {
        const int s = t % ST;
        const uint32_t released = ((t / ST) + 1) & 1;  // tile t - ST's parity
        if (t >= ST) mbar_wait(k_empty(s), released);
        mbar_expect_tx(k_full(s), T::kKVBytes + (bias_row ? T::kBiasBytes : 0));
        tma_load_5d_multicast(sK + s * T::kKVBytes + part, &tk, k_full(s), kMask, 0, t * BN,
                              block, h, b);
        if (bias_row)
          bulk_load(sB + s * T::kBiasBytes, bias_row + t * BN, T::kBiasBytes, k_full(s));
        if (t >= ST) mbar_wait(v_empty(s), released);
        mbar_expect_tx(v_full(s), T::kKVBytes);
        tma_load_5d_multicast(sV + s * T::kKVBytes + part, &tv, v_full(s), kMask, 0, t * BN,
                              block, h, b);
      }
    }
    cluster_sync();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup c owns columns c d / 2 .. of S's contraction
  // and of O, for all 64 rows ----
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const float* bias_tiles = p.bias ? reinterpret_cast<const float*>(generic(sB)) : nullptr;
  float4* x_mine = reinterpret_cast<float4*>(generic(sX)) + c * KT * 128 + tid;
  const float4* x_other = reinterpret_cast<const float4*>(generic(sX)) + (1 - c) * KT * 128 + tid;

  float acc[NC][CW / 8][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < CW / 8; ++i)
      acc[n][i][0] = acc[n][i][1] = acc[n][i][2] = acc[n][i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float sc[KT][4];          // this half's scores of tile t, then S, then P
  uint32_t pf[BN / 16][4];  // tile t - 1's probabilities, bf16: PV's A operand

  // S_t's half over columns c d / 2 .. from stage s (both operands K-major,
  // 16-deep steps; the next 64 columns are the next box)
  auto issue_s = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < T::kHalf / 16; ++ks) {
      const int box = c * (NB / 2) + ks / 4;
      const uint32_t off = (ks % 4) * 32u;
      const uint64_t da = gmma_desc(sQ + box * T::kQBox + off, 16, 1024);
      const uint64_t db = gmma_desc(sK + s * T::kKVBytes + box * T::kKVBox + off, 16, 1024);
      GmmaSS<BN>::run(sc, da, db, ks > 0 ? 1u : 0u);
    }
  };
  // O's columns += P V from stage s (V MN-major: LBO the next 64 columns'
  // box, SBO the next 8 keys; a 16-key step is 2048 bytes)
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int box = (c * T::kHalf + n * CW) / 64;
        GmmaRS<CW>::run(acc[n], pf[kk],
                        gmma_desc(sV + s * T::kKVBytes + box * T::kKVBox + kk * 2048,
                                  T::kKVBox, 1024));
      }
  };
  // S = this half + the other's: write this half, wait for both, add the
  // other (the same sum in both warpgroups), then free the other's buffer
  // for its next tile.
  auto exchange = [&](int t) {
    if (t > 0) named_sync(kBarFree + c, kConsumerThreads);
#pragma unroll
    for (int i = 0; i < KT; ++i)
      x_mine[i * 128] = make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
    named_sync(kBarExchange, kConsumerThreads);
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const float4 o = x_other[i * 128];
      sc[i][0] += o.x;
      sc[i][1] += o.y;
      sc[i][2] += o.z;
      sc[i][3] += o.w;
    }
    if (t + 1 < nkv) named_arrive(kBarFree + (1 - c), kConsumerThreads);
  };
  auto softmax_tile = [&](int t, float (&alpha)[2]) {
    const float* bias = bias_tiles ? bias_tiles + (t % ST) * BN : nullptr;
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
  // a consumer warp is done with a stage: one arrival on its empty barrier
  // in every CTA of the cluster (each of them multicasts into this one)
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(bar, r);
  };
  // before a turn's products: the accumulators' registers are settled
  auto begin = [&]() {
#pragma unroll
    for (int n = 0; n < NC; ++n) gmma_fence_regs(acc[n]);
    gmma_fence();
  };

  mbar_wait(q_full, 0);

  // tile 0: S_0 only
  mbar_wait(k_full(0), 0);
  begin();
  issue_s(0);
  gmma_commit();
  gmma_wait<0>();
  gmma_fence_regs(sc);
  exchange(0);
  {
    float alpha[2];
    softmax_tile(0, alpha);  // the output is still 0: nothing to rescale
  }
  release(k_empty(0));  // K_0 and its bias tile
  pack_p();

  // tile t: S_t with O += P_{t-1} V_{t-1}, then S_t's exchange and softmax
  // while the PV product runs
  for (int t = 1; t < nkv; ++t) {
    const int s = t % ST, sp = (t - 1) % ST;
    mbar_wait(k_full(s), (t / ST) & 1);
    mbar_wait(v_full(sp), ((t - 1) / ST) & 1);
    begin();
    issue_s(s);
    gmma_commit();
    issue_pv(sp);
    gmma_commit();
    gmma_wait<1>();
    gmma_fence_regs(sc);
    exchange(t);
    float alpha[2];
    softmax_tile(t, alpha);
    release(k_empty(s));
    gmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) gmma_fence_regs(acc[n]);
    release(v_empty(sp));
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < CW / 8; ++i) {
          acc[n][i][0] *= alpha[0];
          acc[n][i][1] *= alpha[0];
          acc[n][i][2] *= alpha[1];
          acc[n][i][3] *= alpha[1];
        }
    }
    pack_p();
  }

  // the last PV product
  const int sl = (nkv - 1) % ST;
  mbar_wait(v_full(sl), ((nkv - 1) / ST) & 1);
  begin();
  issue_pv(sl);
  gmma_commit();
  gmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NC; ++n) gmma_fence_regs(acc[n]);

  const long long obase = b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int col0 = c * T::kHalf + n * CW;
    if (p.out_f32)
      store_rows<float, CW / 8>(static_cast<float*>(p.o) + obase, p.o_sl, acc[n], l_r, row0,
                                p.Lq, col0, p.D, tg);
    else
      store_rows<bf16, CW / 8>(static_cast<bf16*>(p.o) + obase, p.o_sl, acc[n], l_r, row0, p.Lq,
                               col0, p.D, tg);
  }
  cluster_sync();  // no peer arrives on this CTA's barriers after it exits
}

// ---- host ----

struct Launch {
  const void *q, *k, *v;
  const long long* maps;  // q, k, v: 4 extents and 3 byte strides each
  int B, block_q, block_k, stages, cluster;
};

template <int D>
cudaError_t launch(const Launch& a, const D512Params& p, cudaStream_t stream) {
  using T = Tiles<D>;
  if (a.block_q != kBlockQ || a.block_k != kBlockK || a.stages != T::kStages ||
      a.cluster != kCluster)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    const long long* m = a.maps + 9 * i;
    const cuuint64_t dims[5] = {(cuuint64_t)m[0], (cuuint64_t)m[1], (cuuint64_t)m[2],
                                (cuuint64_t)m[3], (cuuint64_t)m[4]};
    const cuuint64_t strides[4] = {(cuuint64_t)m[5], (cuuint64_t)m[6], (cuuint64_t)m[7],
                                   (cuuint64_t)m[8]};
    const cuuint32_t box[5] = {64, (cuuint32_t)(i == 0 ? kBlockQ : kBlockK),
                               (cuuint32_t)(i == 0 ? T::kBoxes : T::kBoxes / kCluster), 1, 1};
    if (dims[0] != 64 || dims[2] != (cuuint64_t)T::kBoxes ||
        !encode_tiled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, ptrs[i], dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_d512_kernel<D>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, T::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (p.Lq + kBlockQ - 1) / kBlockQ;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, p.H, a.B);
  kern<<<grid, kThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v (B, H, L, d) through their strides, d 128, 256, 384 or 512.
// `maps`: the q, k and v tensor maps of ops/flash.py's d512_plan, 9 values
// each (5 extents, then the byte strides of axes 1-4); o's strides in
// elements of (B, L, H); the tiles and the cluster, checked against the
// instantiation.
extern "C" int hallo_flash_fwd_d512_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    const long long* maps, int B, int H, int Lq, int Lk, int D,
    long long o_sb, long long o_sl, long long o_sh, long long bias_sb, float scale_log2,
    int out_f32, int block_q, int block_k, int stages, int cluster, void* stream) {
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Launch a{q, k, v, maps, B, block_q, block_k, stages, cluster};
  D512Params p;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale_log2;
  p.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return (int)launch<128>(a, p, st);
    case 256: return (int)launch<256>(a, p, st);
    case 384: return (int)launch<384>(a, p, st);
    case 512: return (int)launch<512>(a, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
