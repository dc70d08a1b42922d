// K1 for Hopper (sm_90a): the packed flash-attention forward with TMA loads,
// wgmma products and a producer warp beside two or three consumer
// warpgroups.
//
// Replaces hallo_tpu/ops/pallas_flash.py:236 `_attention_kernel_packed`
// (reached through `flash_attention_packed`, :745): attention on natural
// (B, L, C = H * d) bf16 tensors, read as the (B, L, H, d) view with its own
// strides, an optional fp32 per-key bias (B, Lk) in natural-log units, and
// with `lse` the base-2 logsumexp of each row (fp32 (B, H, Lq)), which the
// backward (flash_bwd_sm90.cu, K5) recomputes P from. The output is
// normalised and stored in the natural layout, bf16 or fp32 (`out_f32`; the wrapper
// rounds fp32 inputs to bf16 first, as the tensor cores take them).
//
// What bounds it on this card: at the main-path shapes (Lq 4096..64, Lk up
// to 8192, d 40/80/160) the products are far above the memory roofline, so
// the floor is the tensor cores (4 Lq Lk d per head at 989 TFLOP/s) or, at
// d 40, the exponentials: one ex2 per score at 16 a clock per SM (0.127 ms
// for level 0 at B 2 at 1980 MHz, against a 0.087 ms tensor-core bound).
// Measured on an H100 (PERF.md), the softmax's instruction issue binds
// before either: without the ex2s level 0 is only 10-16% faster, and moving
// a share of them to the FMA pipes as a polynomial made it slower. Neither the
// scores nor the probabilities reach device memory.
//
// Design:
// - Block: 64 query rows per consumer warpgroup of one (batch, head): 3
//   warpgroups (192 rows) while d fits one 64-column box, else 2 (the
//   output's registers); warpgroup 0 is the producer (one thread issues
//   TMA; the warpgroup gives its registers to the consumers with
//   setmaxnreg).
// - TMA: a 4-d tensor map per operand, 128-byte swizzle, boxes of 64
//   columns (ceil(d / 64) along d). When a token's heads are adjacent
//   (ops/flash.py: sm90_plan) the maps span its H d columns and a box reads
//   whole 128-byte rows, because TMA fills a box that runs past the
//   innermost extent several times slower than it copies one; the
//   neighbour head's columns that come along are zeroed in Q's and in each
//   K tile's shared copy up to d rounded to 16, so that no value of head
//   h + 1 (not even an inf) reaches head h's scores, and V's are not read.
//   Otherwise each head has its own map and the columns past d read as 0.
//   Query rows past Lq and keys past Lk read as 0 (keys masked to -inf).
//   No copy is made. The per-key bias comes a tile at a time with K, by a
//   bulk copy, already times log2 e and -inf past Lk (ops/flash.py:
//   _tile_bias).
// - Two CTAs of a cluster (neighbouring query blocks) share every K and V
//   tile: each loads half the rows and multicasts them to both, halving the
//   L2 traffic. K and V go through a ring of 3 stages with full barriers
//   (TMA bytes) and empty barriers (one arrival per consumer warp of both
//   CTAs) of their own: K_t (with its bias tile) is released after S_t's
//   softmax, V_t when P_t V_t is done, one turn later.
// - wgmma: S = Q K^T is m64nBNk16 with both operands K-major in shared
//   memory, over d rounded up to 16 (48 at d 40); O += P V is m64n(d)k16
//   with P from registers (the S accumulator repacked to bf16: wgmma's
//   accumulator per 8 columns is mma.sync's m16n8 layout, and its register
//   A operand is mma.sync's A fragment) and V MN-major in shared memory.
// - Softmax: base-2 online softmax in fp32 in the accumulator layout (a
//   row's columns sit in the 4 lanes of a quad): scores times scale * log2 e,
//   plus bias * log2 e, keys >= Lk at -inf; a row whose keys are all -inf
//   gets 0 and LSE kLseEmpty. Row max and sum run in 4 independent chains.
// - Pipelining: a consumer's turn issues S_t = Q K_t^T and O += P_{t-1}
//   V_{t-1} together; S_t's softmax then runs while P_{t-1} V_{t-1} is in
//   flight, and the consumer warpgroups take turns on named barriers, so
//   one warpgroup's exponentials run while another's wgmma run
//   (FlashAttention-3, Shah et al. 2024, arXiv 2407.08608).
//
// The host encodes the three tensor maps per call (cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint, so the library needs no
// -lcuda) and passes them as __grid_constant__ parameters. The maps and
// the tile configuration (block_q, block_k, stages) come from the wrapper
// (ops/flash.py: sm90_plan); the tiles are checked here against the
// instantiation.

#include <cuda.h>

#include <chrono>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// The LSE of a row with no unmasked key: -MASK_VALUE of ops/flash.py.
constexpr float kLseEmpty = 0.7f * 3.4028234663852886e38f;

// named barriers: 1 .. kConsumers the consumers' turns, then one per
// consumer warpgroup of its own
constexpr int kBarSched = 1;
// CTAs of a cluster (neighbouring query tiles of one batch and head): each
// loads 1 / kCluster of every K and V tile and multicasts it to all.
constexpr int kCluster = 2;

struct Sm90Params {
  // (B, bias_sb) fp32 or nullptr: bias * log2 e per key, -inf from Lk to
  // bias_sb, a multiple of the key tile (ops/flash.py: _tile_bias)
  const float* bias;
  void* o;
  float* lse;  // (B, H, Lq) fp32 or nullptr
  int H, Lq, Lk, D;
  long long o_sb, o_sl, o_sh;  // elements
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
  int out_f32;
  int wide;  // the maps span a token's H * d columns (see the host side)
};

template <int DQK>
struct Tiles {
  // consumer warpgroups of 64 query rows: 3 while d fits one box (more warps
  // to hide the softmax's latency, as FlashAttention-3 at d 64), else 2 (the
  // registers of a wider output)
  static constexpr int kConsumers = DQK <= 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockQ = 64 * kConsumers;  // query rows per block
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;  // producer: 24
  static constexpr int kBoxes = (DQK + 63) / 64;  // 64-column boxes along d
  static constexpr int kBlockK = kBoxes <= 2 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kQBox = kBlockQ * 128;  // bytes of one box of Q
  static constexpr int kKVBox = kBlockK * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one stage of K (or of V)
  static constexpr int kBiasBytes = kBlockK * 4;  // one tile of the key bias
  static constexpr int kBarriers = 1 + 4 * kStages;
  // buffers, barriers, and 1024 bytes to align the base to the swizzle atom
  static constexpr int kSmem =
      kQBytes + kStages * (2 * kKVBytes + kBiasBytes) + 8 * kBarriers + 1024;
};

// DQK: d rounded up to 16 (the contraction of S); DV = d (the width of O).
template <int DQK, int DV>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(Tiles<DQK>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Sm90Params p) {
  using T = Tiles<DQK>;
  constexpr int BN = T::kBlockK, NB = T::kBoxes, ST = T::kStages;
  constexpr int KT = BN / 8, DT = DV / 8;
  static_assert(DV % 8 == 0 && DQK % 16 == 0 && DQK >= DV && DQK < DV + 16, "tile widths");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;
  const uint32_t sV = sK + ST * T::kKVBytes;
  // barriers: Q full; per stage K full, V full, K empty, V empty
  const uint32_t sB = sV + ST * T::kKVBytes;  // per stage: the tile's key bias
  const uint32_t bars = sB + ST * T::kBiasBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };

  const int b = blockIdx.z, h = blockIdx.y;
  constexpr int kConsumers = T::kConsumers;
  const int q0 = blockIdx.x * T::kBlockQ;
  const int nkv = (p.Lk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  const uint32_t rank = cluster_ctarank();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      // one arrival per consumer warp of every CTA of the cluster
      mbar_init(k_empty(s), 4 * kConsumers * kCluster);
      mbar_init(v_empty(s), 4 * kConsumers * kCluster);
    }
    mbar_init_fence();
  }
  // the peers' barriers are initialised before any multicast or remote arrival
  cluster_sync();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      // box j of head h: column 64 j of the head's own map, or column
      // h d + 64 j of a wide map over the token's H * d columns
      const int col = p.wide ? h * p.D : 0, head = p.wide ? 0 : h;
      mbar_expect_tx(q_full, T::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sQ + j * T::kQBox, &tq, q_full, col + 64 * j, q0, head, b);
      const float* bias_row = p.bias ? p.bias + b * p.bias_sb : nullptr;
      // this CTA's share of a tile: rows [rank, rank + 1) x BN / kCluster,
      // multicast to the cluster; the stage is free once every CTA's
      // consumers have released it
      constexpr int kPart = BN / kCluster;
      constexpr uint16_t kMask = (1u << kCluster) - 1;
      const int row = rank * kPart;
      const uint32_t part = row * 128;
      for (int t = 0; t < nkv; ++t) {
        const int s = t % ST;
        const uint32_t released = ((t / ST) + 1) & 1;  // tile t - ST's parity
        if (t >= ST) mbar_wait(k_empty(s), released);
        mbar_expect_tx(k_full(s), T::kKVBytes + (bias_row ? T::kBiasBytes : 0));
        for (int j = 0; j < NB; ++j)
          tma_load_4d_multicast(sK + s * T::kKVBytes + j * T::kKVBox + part, &tk, k_full(s),
                                kMask, col + 64 * j, t * BN + row, head, b);
        if (bias_row)
          bulk_load(sB + s * T::kBiasBytes, bias_row + t * BN, T::kBiasBytes, k_full(s));
        if (t >= ST) mbar_wait(v_empty(s), released);
        mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int j = 0; j < NB; ++j)
          tma_load_4d_multicast(sV + s * T::kKVBytes + j * T::kKVBox + part, &tv, v_full(s),
                                kMask, col + 64 * j, t * BN + row, head, b);
      }
    }
    cluster_sync();
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
    // the key bias tiles, as a generic pointer
    const float* bias_tiles =
        p.bias ? reinterpret_cast<const float*>(smem_raw + (sB - smem_u32(smem_raw))) : nullptr;
    const uint32_t qa = sQ + cw * 64 * 128;

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    float sc[KT][4];          // scores of tile t, then its probabilities
    uint32_t pf[BN / 16][4];  // tile t - 1's probabilities, bf16: PV's A operand

    // S_t = Q K_t^T from stage s (both operands K-major, 16-deep steps; the
    // next 64 columns are the next box)
    auto issue_s = [&](int s) {
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32u;
        const uint64_t da = gmma_desc(qa + (ks / 4) * T::kQBox + off, 16, 1024);
        const uint64_t db = gmma_desc(sK + s * T::kKVBytes + (ks / 4) * T::kKVBox + off, 16, 1024);
        GmmaSS<BN>::run(sc, da, db, ks > 0 ? 1u : 0u);
      }
    };
    // O += P V from stage s (V MN-major: LBO the next 64 columns' box, SBO
    // the next 8 keys; a 16-key step is 2048 bytes)
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        GmmaRS<DV>::run(acc, pf[kk],
                        gmma_desc(sV + s * T::kKVBytes + kk * 2048, T::kKVBox, 1024));
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
    // A turn: this warpgroup issues its products while the other one runs
    // its softmax. Warpgroup cw 0 goes first; each waits on its own named
    // barrier and hands the turn over after issuing.
    auto turn_begin = [&]() {
      named_sync(kBarSched + cw, 2 * 128);
      gmma_fence_regs(acc);
      gmma_fence();
    };
    auto turn_end = [&]() { named_arrive(kBarSched + (cw + 1) % kConsumers, 2 * 128); };
    if (cw == kConsumers - 1) named_arrive(kBarSched + 0, 2 * 128);
    // a consumer warp is done with a stage: one arrival on its empty barrier
    // in every CTA of the cluster (each of them multicasts into this one)
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(bar, c);
    };
    // Under a wide map the contraction's pad columns d .. d + 7 of Q and K
    // are the next head's: both are zeroed in shared memory (one 16-byte
    // chunk a row, at its swizzled place), so head h's scores never read
    // head h + 1's values (an inf there would give 0 x inf). Per-head maps
    // read them as 0.
    constexpr int kChunk = (DV % 64) / 8;
    const bool pad = DQK > DV && p.wide;
    mbar_wait(q_full, 0);
    if (pad) {
      zero_chunk_rows(qa + (DV / 64) * T::kQBox, kChunk, 64, tid, 128);
      fence_proxy_async();
      named_sync(kBarSched + kConsumers + cw, 128);
    }
    // every consumer warpgroup zeroes the whole K tile of stage s (the same
    // zeros: the tile is shared) before its own products read it
    auto wait_k = [&](int t) {
      const int s = t % ST;
      mbar_wait(k_full(s), (t / ST) & 1);
      if (pad) {
        zero_chunk_rows(sK + s * T::kKVBytes + (DV / 64) * T::kKVBox, kChunk, BN, tid, 128);
        fence_proxy_async();
        named_sync(kBarSched + kConsumers + cw, 128);
      }
    };

    // tile 0: S_0 only
    wait_k(0);
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
      const int s = t % ST, sp = (t - 1) % ST;
      wait_k(t);
      mbar_wait(v_full(sp), ((t - 1) / ST) & 1);
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
    const int sl = (nkv - 1) % ST;
    mbar_wait(v_full(sl), ((nkv - 1) / ST) & 1);
    turn_begin();
    issue_pv(sl);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(acc);
    // the other warpgroup's last hand-over, which no turn waits for
    if (cw == 0) named_sync(kBarSched + 0, 2 * 128);

    const long long obase = b * p.o_sb + h * p.o_sh;
    if (p.out_f32)
      store_rows<float, DT>(static_cast<float*>(p.o) + obase, p.o_sl, acc, l_r, row0, p.Lq, 0,
                            p.D, tg);
    else
      store_rows<bf16, DT>(static_cast<bf16*>(p.o) + obase, p.o_sl, acc, l_r, row0, p.Lq, 0,
                           p.D, tg);
    if (p.lse != nullptr) {
      // m + log2(l); kLseEmpty where every key was masked (l = 0), so that
      // the backward's exp2(s - lse) recomputes 0 there, never inf or NaN.
      const float l0 = quad_sum(l_r[0]), l1 = quad_sum(l_r[1]);
      float* lb = p.lse + ((long long)b * p.H + h) * p.Lq;
      if (tg == 0) {
        if (row0 < p.Lq) lb[row0] = l0 > 0.f ? m_r[0] + log2f(l0) : kLseEmpty;
        if (row0 + 8 < p.Lq) lb[row0 + 8] = l1 > 0.f ? m_r[1] + log2f(l1) : kLseEmpty;
      }
    }
    cluster_sync();  // no peer arrives on this CTA's barriers after it exits
  }
}

// ---- host ----

struct Launch {
  const void *q, *k, *v;
  const long long* maps;  // q, k, v: 4 extents and 3 byte strides each
  int B, block_q, block_k, stages;
};

template <int DQK, int DV>
cudaError_t launch(const Launch& a, const Sm90Params& p, cudaStream_t stream) {
  using T = Tiles<DQK>;
  if (a.block_q != T::kBlockQ || a.block_k != T::kBlockK || a.stages != T::kStages)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, a.q, a.maps, a.maps + 4, T::kBlockQ) ||
      !encode_map(&tk, a.k, a.maps + 7, a.maps + 11, T::kBlockK / kCluster) ||
      !encode_map(&tv, a.v, a.maps + 14, a.maps + 18, T::kBlockK / kCluster))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_sm90_kernel<DQK, DV>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, T::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int tiles = (p.Lq + T::kBlockQ - 1) / T::kBlockQ;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, p.H, a.B);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

#define K1_CASE(DV) \
  case DV:          \
    return launch<((DV) + 15) / 16 * 16, DV>(a, p, st);

cudaError_t dispatch(const Launch& a, const Sm90Params& p, cudaStream_t st) {
  switch (p.D) {
    K1_CASE(8) K1_CASE(16) K1_CASE(24) K1_CASE(32) K1_CASE(40)
    K1_CASE(48) K1_CASE(56) K1_CASE(64) K1_CASE(72) K1_CASE(80)
    K1_CASE(88) K1_CASE(96) K1_CASE(104) K1_CASE(112) K1_CASE(120)
    K1_CASE(128) K1_CASE(136) K1_CASE(144) K1_CASE(152) K1_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
}

#undef K1_CASE

}  // namespace

// bf16 q, k, v; d any multiple of 8 up to 160. `maps`: the q, k and v
// tensor maps of ops/flash.py's sm90_plan, 7 values each (4 extents, then
// the byte strides of axes 1-3); o's strides in elements of (B, L, H).
extern "C" int hallo_flash_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
    const long long* maps, int B, int H, int Lq, int Lk, int D,
    long long o_sb, long long o_sl, long long o_sh, long long bias_sb, float scale_log2,
    int out_f32, int wide, int block_q, int block_k, int stages, void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 160 || Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  Launch a{q, k, v, maps, B, block_q, block_k, stages};
  Sm90Params p;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale_log2;
  p.out_f32 = out_f32;
  p.wide = wide;
  return (int)dispatch(a, p, static_cast<cudaStream_t>(stream));
}

// Host nanoseconds of `iters` encodings of a call's three tensor maps
// (`maps` as above; the per-call host work the kernel adds), or -1 if one
// fails.
extern "C" int hallo_flash_sm90_encode_ns(const void* q, const void* k, const void* v,
                                         const long long* maps, int block_q, int block_k,
                                         int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_map(&map, q, maps, maps + 4, block_q) ||
        !encode_map(&map, k, maps + 7, maps + 11, block_k) ||
        !encode_map(&map, v, maps + 14, maps + 18, block_k))
      return -1;
  return (int)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - t0)
      .count();
}
