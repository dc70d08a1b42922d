// K5 for Hopper (sm_90a): the two-pass flash-attention backward with TMA
// rings, wgmma products and a producer warp beside two consumer
// warpgroups. Deterministic: no atomics, every sum in a fixed order.
//
// Replaces hallo_tpu/ops/pallas_flash.py:425 `_dkv_kernel_packed` (dK, dV)
// and :497 `_dq_kernel_packed` (dQ), driven by `_flash_backward_packed`
// (:552-682), the backward of K1 (flash_fwd_sm90.cu) on natural
// (B, L, C = H * d) bf16 tensors read as their (B, L, H, d) views. Both
// passes recompute the probabilities from K1's saved base-2 LSE:
//
//   s  = (q . k) * scale * log2(e) + bias * log2(e)   (the forward's logits)
//   P  = exp2(s - lse)
//   dV = P^T dO          dP = dO V^T
//   dS = P * (dP - Delta),  Delta = rowsum(dO * O)    (fp32, from the wrapper)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// The bias gets no gradient (every bias of the model is a constant mask;
// JAX returns a zero cotangent, pallas_flash.py:723-739). The outputs are
// stored in the natural layout, bf16 or fp32 (`out_f32`; the wrapper rounds
// fp32 inputs to bf16 first, as the tensor cores take them).
//
// What bounds it on this card. Level 0 of the stage-2 step (B 14, 8 heads
// of d 40, Lq 4096, Lk 8192): the dK/dV pass does four products of
// 2 Lq Lk d per head (1.2160 ms at 989 TFLOP/s), the dQ pass three (0.9120
// ms); far above the memory roofline. Each pass also takes one ex2 per
// score: 14 * 8 * 4096 * 8192 at 16 a clock per SM on 132 SMs at 1980 MHz
// is 0.8987 ms, the same floor as K1's. Around the ex2 each score costs
// about five FP32 instructions (the logit's FMA, the bias and LSE terms,
// dP - Delta, the product), so, like K1 at d 40, the passes are likely
// bound by instruction issue in the elementwise work rather than by the
// tensor cores.
//
// Design:
// - Two passes, as in JAX, so no sum crosses CTAs in an order that could
//   change between runs: two launches on the same inputs give bit-identical
//   dQ, dK and dV.
// - Warpgroup 0 is the producer (one thread issues TMA and bulk copies,
//   the warpgroup gives its registers away with setmaxnreg); warpgroups 1
//   and 2 are consumers of 64 rows each, and take turns on named barriers
//   so that one's elementwise work runs while the other's wgmma do
//   (FlashAttention-3's ping-pong, Shah et al. 2024, arXiv 2407.08608).
// - dK/dV pass: a CTA owns 128 keys (64 a consumer). K and V arrive once
//   by TMA; the per-key bias is read into registers once (constant over
//   the loop). Q and dO tiles of 64 queries (32 above d 96: registers),
//   with their LSE and Delta slices (bulk copies), stream through a ring of
//   4 stages. Per tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma (both
//   operands K-major), then P^T and dS^T in the accumulator layout, re-packed
//   as bf16 A fragments for dV += P^T dO and dK += dS^T Q as RS wgmma (dO
//   and Q the MN-major B operands, as V in K1's PV). A turn issues tile t's
//   SS products with tile t - 1's RS products; t's elementwise work runs
//   while t - 1's RS products are in flight. dK and dV stay in registers.
// - At Lk <= 64 (the audio and identity cross-attention) the second
//   consumer's 64 keys would all be past Lk: both consumers then take the
//   same 64 keys and alternate query tiles (each owning every other stage
//   of the ring), and the second one's dK and dV are added to the first
//   one's through shared memory at the end, in a fixed order. Where the key tiles leave SMs idle (B H ceil(Lk / 128) CTAs
//   against 132 SMs), the query range is split over CTAs into fp32
//   partials that the wrapper sums in order (ops/flash.py: bwd_plan).
// - dQ pass: a CTA owns 128 queries (64 a consumer); Q and dO arrive by
//   TMA with the rows' LSE and Delta in registers; K, V (and the bias tile,
//   by a bulk copy) stream through a ring of 3 stages (2 at two or three
//   64-column boxes: shared memory), each CTA of a cluster of two loading
//   half of every K/V tile and multicasting it to both, as K1 does. Per
//   tile: S = Q K^T and dP = dO V^T (SS), then dS, then dQ += dS K (RS, K
//   the MN-major B). V is released after dP, K after dS K. Where there
//   are at most two key tiles (Lk <= 256 at d <= 96), a CTA walks several
//   query tiles, the producer loading the next Q and dO (double-buffered
//   while d fits one box) while the current one is worked on; with one key
//   tile (the audio and identity lengths) K and V stay in shared memory for
//   all of them, and up to d 64 a key tile is 32 keys where Lk <= 32.
// - TMA maps as K1's (ops/flash.py): 128-byte swizzle, boxes of 64
//   columns, wide maps over a token's H d columns when its heads are
//   adjacent. Under a wide map the contraction's pad columns (d up to d
//   rounded to 16) of Q, K, dO and V are the next head's: each is zeroed in
//   shared memory after it lands and before a product reads it, so no value
//   of head h + 1 (not even an inf) reaches head h's gradients. Rows past
//   Lq or Lk read as 0; keys past Lk take bias -inf (P = 0), query rows
//   past Lq LSE +inf (P = 0); only the real rows are stored.
//
// The host encodes the four tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, sm90_common.cuh) and passes them as
// __grid_constant__ parameters; the tiles, stages, splits and grid come
// from the wrapper's plan and are checked here against the instantiation.

#include <cuda.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerRegs = 240;  // the producer keeps 24
constexpr int kCluster = 2;         // the dQ pass's K/V multicast
// named barriers: kBarTurn + cw the consumers' turns, kBarWg + cw one per
// consumer warpgroup, kBarAll both consumer warpgroups
constexpr int kBarTurn = 1;
constexpr int kBarWg = 3;
constexpr int kBarAll = 5;

struct BwdParams {
  // (B, bias_sb) fp32 or nullptr: bias * log2 e per key, -inf from Lk to
  // bias_sb (ops/flash.py: _tile_bias)
  const float* bias;
  const float* lse;    // (B, H, Lqp): K1's base-2 LSE, +inf past Lq
  const float* delta;  // (B, H, Lqp): rowsum(dO * O), 0 past Lq
  void* out0;          // dK (dK/dV pass) or dQ (dQ pass): (B, L, C)
  void* out1;          // dV (dK/dV pass)
  int H, Lq, Lk, D, Lqp;
  long long bias_sb;
  long long split_stride;  // elements between two splits' partials
  float scale, scale_log2;
  int out_f32, wide;
  int tiles;     // query tiles per CTA (dQ) or per split (dK/dV)
  int wg_split;  // dK/dV at Lk <= 64: both consumers on the same 64 keys
};

// BKQ: the dQ pass's key tile, or 0 for its default
template <int DQK, int DV, int BKQ = 0>
struct Tiles {
  static constexpr int kBoxes = (DQK + 63) / 64;  // 64-column boxes along d
  static constexpr bool kPad = DQK > DV;          // d % 16 == 8
  static constexpr int kChunk = (DV % 64) / 8;    // the pad's 16-byte chunk
  static constexpr int kPadBox = DV / 64;         // ... in this box
  // dK/dV pass
  static constexpr int kDkvKeys = 64 * kConsumers;
  static constexpr int kDkvQ = DV <= 96 ? 64 : 32;
  // even: where the two consumers take alternate query tiles (Lk <= 64),
  // each then owns every other stage and waits on all of its phases in
  // order. A parity wait is sound only so: in an odd ring tile i's stage
  // last held the other consumer's tile, and the wait on tile i would pass
  // at once while that tile was still landing.
  static constexpr int kDkvStages = 4;
  static constexpr int kDkvKVBox = kDkvKeys * 128;
  static constexpr int kDkvKVBytes = kBoxes * kDkvKVBox;
  static constexpr int kDkvQBox = kDkvQ * 128;
  static constexpr int kDkvQBytes = kBoxes * kDkvQBox;
  static constexpr int kDkvStatBytes = kDkvQ * 4;
  static constexpr int kDkvBarriers = 1 + 2 * kDkvStages;
  static constexpr int kDkvSmem = 2 * kDkvKVBytes +
                                  kDkvStages * (2 * kDkvQBytes + 2 * kDkvStatBytes) +
                                  8 * kDkvBarriers + 1024;
  // dQ pass
  static constexpr int kDqQ = 64 * kConsumers;
  static constexpr int kDqK = BKQ ? BKQ : DV <= 96 ? 128 : 64;
  static constexpr int kDqStages = kBoxes == 1 ? 3 : 2;
  static constexpr int kDqQBufs = kBoxes == 1 ? 2 : 1;
  static constexpr int kDqQBox = kDqQ * 128;
  static constexpr int kDqQBytes = kBoxes * kDqQBox;
  static constexpr int kDqKVBox = kDqK * 128;
  static constexpr int kDqKVBytes = kBoxes * kDqKVBox;
  static constexpr int kDqBiasBytes = kDqK * 4;
  static constexpr int kDqBarriers = 2 * kDqQBufs + 4 * kDqStages;
  static constexpr int kDqSmem = kDqQBufs * 2 * kDqQBytes +
                                 kDqStages * (2 * kDqKVBytes + kDqBiasBytes) +
                                 8 * kDqBarriers + 1024;
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};

template <int C>
__device__ __forceinline__ void zero_acc(float (&d)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
}

// bf16 A fragments (16 columns each) from a 64 x (8 C) accumulator: for
// each 8 columns wgmma's accumulator is mma.sync's m16n8 layout, and its
// register A operand is mma.sync's m16n8k16 A fragment.
template <int C>
__device__ __forceinline__ void pack_a(uint32_t (&a)[C / 2][4], const float (&d)[C][4]) {
#pragma unroll
  for (int kk = 0; kk < C / 2; ++kk) {
    a[kk][0] = pack_bf16(d[2 * kk][0], d[2 * kk][1]);
    a[kk][1] = pack_bf16(d[2 * kk][2], d[2 * kk][3]);
    a[kk][2] = pack_bf16(d[2 * kk + 1][0], d[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(d[2 * kk + 1][2], d[2 * kk + 1][3]);
  }
  gmma_fence_regs(a);
}

// A generic pointer to a shared-memory address.
__device__ __forceinline__ const float* smem_ptr(unsigned char* base, uint32_t addr) {
  return reinterpret_cast<const float*>(base + (addr - smem_u32(base)));
}

// ---- dK/dV pass ----

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg, const BwdParams p) {
  using T = Tiles<DQK, DV>;
  constexpr int BQ = T::kDkvQ, NB = T::kBoxes, ST = T::kDkvStages;
  constexpr int QT = BQ / 8, DT = DV / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::kDkvKVBytes;
  const uint32_t sQ = sV + T::kDkvKVBytes;         // per stage: Q
  const uint32_t sO = sQ + ST * T::kDkvQBytes;     // per stage: dO
  const uint32_t sL = sO + ST * T::kDkvQBytes;     // per stage: the LSE slice
  const uint32_t sD = sL + ST * T::kDkvStatBytes;  // per stage: the Delta slice
  // barriers: K and V full; per stage full, empty
  const uint32_t bars = sD + ST * T::kDkvStatBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int b = blockIdx.z, h = blockIdx.y;
  const int nk = (p.Lk + T::kDkvKeys - 1) / T::kDkvKeys;
  const int split = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * T::kDkvKeys;
  const int nq = (p.Lq + BQ - 1) / BQ;
  const int t0 = split * p.tiles;
  const int n = min(p.tiles, nq - t0);  // at least 1 (the plan's splits)
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // consumer warpgroups that read each query tile
  const int readers = p.wg_split ? 1 : kConsumers;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * readers);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then the ring of Q, dO, LSE, Delta ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tg);
      // box j of head h: column 64 j of the head's own map, or column
      // h d + 64 j of a wide map over the token's H * d columns
      const int col = p.wide ? h * p.D : 0, head = p.wide ? 0 : h;
      mbar_expect_tx(kv_full, 2 * T::kDkvKVBytes);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sK + j * T::kDkvKVBox, &tk, kv_full, col + 64 * j, k0, head, b);
        tma_load_4d(sV + j * T::kDkvKVBox, &tv, kv_full, col + 64 * j, k0, head, b);
      }
      const long long stats = ((long long)b * p.H + h) * p.Lqp;
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) + 1) & 1);  // tile i - ST's parity
        mbar_expect_tx(full(s), 2 * T::kDkvQBytes + 2 * T::kDkvStatBytes);
        const int q0 = (t0 + i) * BQ;
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sQ + s * T::kDkvQBytes + j * T::kDkvQBox, &tq, full(s), col + 64 * j, q0,
                      head, b);
          tma_load_4d(sO + s * T::kDkvQBytes + j * T::kDkvQBox, &tg, full(s), col + 64 * j, q0,
                      head, b);
        }
        bulk_load(sL + s * T::kDkvStatBytes, p.lse + stats + q0, T::kDkvStatBytes, full(s));
        bulk_load(sD + s * T::kDkvStatBytes, p.delta + stats + q0, T::kDkvStatBytes, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63 (at Lk <= 64
  // both own keys k0 .. k0 + 63 and take every other query tile) ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg4 = lane & 3;
  const int rows = p.wg_split ? 0 : cw * 64;
  const int key0 = k0 + rows + warp * 16 + g;  // and key0 + 8
  // this thread's two keys' bias (log2 units; -inf past Lk): constant
  // over the whole query loop
  const float* brow = p.bias ? p.bias + (long long)b * p.bias_sb : nullptr;
  const float kb0 = brow ? brow[key0] : (key0 < p.Lk ? 0.f : -INFINITY);
  const float kb1 = brow ? brow[key0 + 8] : (key0 + 8 < p.Lk ? 0.f : -INFINITY);
  const uint32_t ka = sK + rows * 128, va = sV + rows * 128;
  const float* lse_s = smem_ptr(smem_raw, sL);
  const float* delta_s = smem_ptr(smem_raw, sD);
  const bool pad = T::kPad && p.wide;
  const bool turns = !p.wg_split;

  float dk[DT][4], dv[DT][4];
  zero_acc(dk);
  zero_acc(dv);
  float st[QT][4], dpt[QT][4];           // S^T then P^T; dP^T then dS^T
  uint32_t pf[QT / 2][4], dsf[QT / 2][4];  // P^T and dS^T, bf16: the RS A operands

  auto wg_sync = [&]() { named_sync(kBarWg + cw, 128); };
  mbar_wait(kv_full, 0);
  if (pad) {
    zero_chunk_rows(ka + T::kPadBox * T::kDkvKVBox, T::kChunk, 64, tid, 128);
    zero_chunk_rows(va + T::kPadBox * T::kDkvKVBox, T::kChunk, 64, tid, 128);
    fence_proxy_async();
    wg_sync();
  }
  // tile i landed; under a wide map every reader zeroes the pad of the
  // whole Q and dO tile (the same zeros: the tile is shared)
  auto wait_tile = [&](int i) {
    const int s = i % ST;
    mbar_wait(full(s), (i / ST) & 1);
    if (pad) {
      zero_chunk_rows(sQ + s * T::kDkvQBytes + T::kPadBox * T::kDkvQBox, T::kChunk, BQ, tid,
                      128);
      zero_chunk_rows(sO + s * T::kDkvQBytes + T::kPadBox * T::kDkvQBox, T::kChunk, BQ, tid,
                      128);
      fence_proxy_async();
      wg_sync();
    }
  };
  // S^T = K Q^T and dP^T = V dO^T from stage s (all K-major, 16-deep
  // steps; the next 64 columns are the next box)
  auto issue_ss = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::kDkvKVBox + (ks % 4) * 32u;
      const uint32_t qoff = s * T::kDkvQBytes + (ks / 4) * T::kDkvQBox + (ks % 4) * 32u;
      GmmaSS<BQ>::run(st, gmma_desc(ka + off, 16, 1024), gmma_desc(sQ + qoff, 16, 1024),
                      ks > 0 ? 1u : 0u);
    }
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::kDkvKVBox + (ks % 4) * 32u;
      const uint32_t qoff = s * T::kDkvQBytes + (ks / 4) * T::kDkvQBox + (ks % 4) * 32u;
      GmmaSS<BQ>::run(dpt, gmma_desc(va + off, 16, 1024), gmma_desc(sO + qoff, 16, 1024),
                      ks > 0 ? 1u : 0u);
    }
  };
  // dV += P^T dO and dK += dS^T Q from stage s (dO and Q MN-major: LBO the
  // next 64 columns' box, SBO the next 8 queries; a 16-query step is 2048
  // bytes)
  auto issue_rs = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t off = s * T::kDkvQBytes + kk * 2048;
      GmmaRS<DV>::run(dv, pf[kk], gmma_desc(sO + off, T::kDkvQBox, 1024));
      GmmaRS<DV>::run(dk, dsf[kk], gmma_desc(sQ + off, T::kDkvQBox, 1024));
    }
  };
  // P^T = exp2(s^T scale log2 e + bias - lse) and dS^T = P^T (dP^T - Delta)
  // for this thread's keys (rows) and queries (columns 8 i + 2 tg + {0, 1})
  auto elementwise = [&](int s) {
    const float2* l2 = reinterpret_cast<const float2*>(lse_s + s * BQ);
    const float2* d2 = reinterpret_cast<const float2*>(delta_s + s * BQ);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float2 l = l2[4 * i + tg4], dd = d2[4 * i + tg4];
      const float p0 = fast_exp2(fmaf(st[i][0], p.scale_log2, kb0 - l.x));
      const float p1 = fast_exp2(fmaf(st[i][1], p.scale_log2, kb0 - l.y));
      const float p2 = fast_exp2(fmaf(st[i][2], p.scale_log2, kb1 - l.x));
      const float p3 = fast_exp2(fmaf(st[i][3], p.scale_log2, kb1 - l.y));
      dpt[i][0] = p0 * (dpt[i][0] - dd.x);
      dpt[i][1] = p1 * (dpt[i][1] - dd.y);
      dpt[i][2] = p2 * (dpt[i][2] - dd.x);
      dpt[i][3] = p3 * (dpt[i][3] - dd.y);
      st[i][0] = p0;
      st[i][1] = p1;
      st[i][2] = p2;
      st[i][3] = p3;
    }
  };
  // A turn: this warpgroup issues its products while the other one runs
  // its elementwise work (not at Lk <= 64, where the two warpgroups walk
  // different tiles and may take different numbers of turns)
  auto turn_begin = [&]() {
    if (turns) named_sync(kBarTurn + cw, 2 * 128);
    gmma_fence_regs(dk);
    gmma_fence_regs(dv);
    gmma_fence();
  };
  auto turn_end = [&]() {
    if (turns) named_arrive(kBarTurn + (cw + 1) % kConsumers, 2 * 128);
  };
  if (turns && cw == kConsumers - 1) named_arrive(kBarTurn + 0, 2 * 128);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };

  const int first = p.wg_split ? cw : 0, stride = p.wg_split ? kConsumers : 1;
  const int mine = n > first ? (n - first + stride - 1) / stride : 0;
  if (mine > 0) {
    // the first tile: its SS products only
    int i = first;
    wait_tile(i);
    turn_begin();
    issue_ss(i % ST);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(st);
    gmma_fence_regs(dpt);
    elementwise(i % ST);
    pack_a<QT>(pf, st);
    pack_a<QT>(dsf, dpt);
    // tile i: its SS products with the previous tile's RS products in one
    // turn, then its elementwise work while the RS products run
    for (int m = 1; m < mine; ++m) {
      const int sp = i % ST;
      i += stride;
      const int s = i % ST;
      wait_tile(i);
      turn_begin();
      issue_ss(s);
      gmma_commit();
      issue_rs(sp);
      gmma_commit();
      turn_end();
      gmma_wait<1>();
      gmma_fence_regs(st);
      gmma_fence_regs(dpt);
      elementwise(s);
      gmma_wait<0>();
      gmma_fence_regs(dk);
      gmma_fence_regs(dv);
      release(sp);
      pack_a<QT>(pf, st);
      pack_a<QT>(dsf, dpt);
    }
    // the last RS products
    const int sl = i % ST;
    turn_begin();
    issue_rs(sl);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(dk);
    gmma_fence_regs(dv);
    release(sl);
  }
  // the other warpgroup's last hand-over, which no turn waits for
  if (turns && cw == 0) named_sync(kBarTurn + 0, 2 * 128);

  if (p.wg_split) {
    // the second warpgroup's dK and dV are added to the first one's in K's
    // buffer, free once both are done with their products: dK + dK' and
    // dV + dV' in this order in every run
    float* x = reinterpret_cast<float*>(smem_raw + (sK - smem_u32(smem_raw)));
    named_sync(kBarAll, 2 * 128);
    if (cw == 1) {
#pragma unroll
      for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[(i * 4 + e) * 128 + tid] = dk[i][e];
          x[((DT + i) * 4 + e) * 128 + tid] = dv[i][e];
        }
    }
    named_sync(kBarAll, 2 * 128);
    if (cw == 1) return;
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[i][e] += x[(i * 4 + e) * 128 + tid];
        dv[i][e] += x[((DT + i) * 4 + e) * 128 + tid];
      }
  }

  const long long C = (long long)p.H * p.D;
  const long long base = split * p.split_stride + (long long)b * p.Lk * C + (long long)h * p.D;
  if (p.out_f32) {
    store_scaled<float, DT>(static_cast<float*>(p.out0) + base, C, dk, p.scale, p.scale, key0,
                            p.Lk, 0, p.D, tg4);
    store_scaled<float, DT>(static_cast<float*>(p.out1) + base, C, dv, 1.f, 1.f, key0, p.Lk, 0,
                            p.D, tg4);
  } else {
    store_scaled<bf16, DT>(static_cast<bf16*>(p.out0) + base, C, dk, p.scale, p.scale, key0,
                           p.Lk, 0, p.D, tg4);
    store_scaled<bf16, DT>(static_cast<bf16*>(p.out1) + base, C, dv, 1.f, 1.f, key0, p.Lk, 0,
                           p.D, tg4);
  }
}

// ---- dQ pass ----

template <int DQK, int DV, int BKQ>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg, const BwdParams p) {
  using T = Tiles<DQK, DV, BKQ>;
  constexpr int BK = T::kDqK, NB = T::kBoxes, ST = T::kDqStages, QB = T::kDqQBufs;
  constexpr int KT = BK / 8, DT = DV / 8;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // per query buffer: Q
  const uint32_t sO = sQ + QB * T::kDqQBytes;                 // per query buffer: dO
  const uint32_t sK = sO + QB * T::kDqQBytes;                 // per stage
  const uint32_t sV = sK + ST * T::kDqKVBytes;
  const uint32_t sB = sV + ST * T::kDqKVBytes;  // per stage: the tile's key bias
  // barriers: per query buffer full, empty; per stage K full, V full, K
  // empty, V empty
  const uint32_t bars = sB + ST * T::kDqBiasBytes;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (QB + i); };
  auto k_full = [&](int s) { return bars + 8 * (2 * QB + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 * QB + ST + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 * QB + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 * QB + 3 * ST + s); };

  const int b = blockIdx.z, h = blockIdx.y;
  const int nkv = (p.Lk + BK - 1) / BK;
  // one key tile (short Lk): K, V and the bias tile stay in stage 0 for
  // every query tile of the CTA, loaded and zeroed once
  const bool resident = nkv == 1;
  const int j0 = blockIdx.x * p.tiles;  // this CTA's first query tile
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  const uint32_t rank = cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * kConsumers);
    }
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
    // ---- producer: Q and dO per query tile, the K/V ring across them ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tg);
      const int col = p.wide ? h * p.D : 0, head = p.wide ? 0 : h;
      const float* bias_row = p.bias ? p.bias + (long long)b * p.bias_sb : nullptr;
      // this CTA's share of a K/V tile: rows [rank, rank + 1) x BK /
      // kCluster, multicast to the cluster
      constexpr int kPart = BK / kCluster;
      constexpr uint16_t kMask = (1u << kCluster) - 1;
      const int row = rank * kPart;
      const uint32_t part = row * 128;
      int it = 0;  // K/V tiles issued so far
      for (int jj = 0; jj < p.tiles; ++jj) {
        const int qb = jj % QB;
        if (jj >= QB) mbar_wait(q_empty(qb), ((jj / QB) + 1) & 1);
        const int q0 = (j0 + jj) * T::kDqQ;
        mbar_expect_tx(q_full(qb), 2 * T::kDqQBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(sQ + qb * T::kDqQBytes + j * T::kDqQBox, &tq, q_full(qb), col + 64 * j, q0,
                      head, b);
          tma_load_4d(sO + qb * T::kDqQBytes + j * T::kDqQBox, &tg, q_full(qb), col + 64 * j, q0,
                      head, b);
        }
        const int loads = resident && jj > 0 ? 0 : nkv;
        for (int t = 0; t < loads; ++t, ++it) {
          const int s = it % ST;
          const uint32_t released = ((it / ST) + 1) & 1;  // tile it - ST's parity
          if (it >= ST) mbar_wait(k_empty(s), released);
          mbar_expect_tx(k_full(s), T::kDqKVBytes + (bias_row ? T::kDqBiasBytes : 0));
          for (int j = 0; j < NB; ++j)
            tma_load_4d_multicast(sK + s * T::kDqKVBytes + j * T::kDqKVBox + part, &tk, k_full(s),
                                  kMask, col + 64 * j, t * BK + row, head, b);
          if (bias_row)
            bulk_load(sB + s * T::kDqBiasBytes, bias_row + t * BK, T::kDqBiasBytes, k_full(s));
          if (it >= ST) mbar_wait(v_empty(s), released);
          mbar_expect_tx(v_full(s), T::kDqKVBytes);
          for (int j = 0; j < NB; ++j)
            tma_load_4d_multicast(sV + s * T::kDqKVBytes + j * T::kDqKVBox + part, &tv, v_full(s),
                                  kMask, col + 64 * j, t * BK + row, head, b);
        }
      }
    }
    cluster_sync();
    return;
  }

  // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 of
  // each of the CTA's query tiles ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg4 = lane & 3;
  const float* bias_tiles = p.bias ? smem_ptr(smem_raw, sB) : nullptr;
  const long long stats = ((long long)b * p.H + h) * p.Lqp;
  const bool pad = T::kPad && p.wide;
  const long long C = (long long)p.H * p.D;

  float dq[DT][4];
  float sc[KT][4], dp[KT][4];  // S then dS; dP
  uint32_t dsf[KT / 2][4];     // dS, bf16: the RS A operand

  auto wg_sync = [&]() { named_sync(kBarWg + cw, 128); };
  auto turn_begin = [&]() {
    named_sync(kBarTurn + cw, 2 * 128);
    gmma_fence_regs(dq);
    gmma_fence();
  };
  auto turn_end = [&]() { named_arrive(kBarTurn + (cw + 1) % kConsumers, 2 * 128); };
  if (cw == kConsumers - 1) named_arrive(kBarTurn + 0, 2 * 128);
  // a consumer warp is done with a stage: one arrival on its empty barrier
  // in every CTA of the cluster (each of them multicasts into this one)
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0)
      for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(bar, c);
  };
  // K/V tile i landed; under a wide map every consumer warpgroup zeroes the
  // pad of the whole K and V tile (the same zeros: the tile is shared)
  auto wait_kv = [&](int i, bool fresh) {
    const int s = i % ST;
    mbar_wait(k_full(s), (i / ST) & 1);
    mbar_wait(v_full(s), (i / ST) & 1);
    if (pad && fresh) {
      zero_chunk_rows(sK + s * T::kDqKVBytes + T::kPadBox * T::kDqKVBox, T::kChunk, BK, tid, 128);
      zero_chunk_rows(sV + s * T::kDqKVBytes + T::kPadBox * T::kDqKVBox, T::kChunk, BK, tid, 128);
      fence_proxy_async();
      wg_sync();
    }
  };
  // S = Q K^T and dP = dO V^T from stage s (all K-major)
  auto issue_ss = [&](uint32_t qa, uint32_t oa, int s) {
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::kDqQBox + (ks % 4) * 32u;
      const uint32_t koff = s * T::kDqKVBytes + (ks / 4) * T::kDqKVBox + (ks % 4) * 32u;
      GmmaSS<BK>::run(sc, gmma_desc(qa + off, 16, 1024), gmma_desc(sK + koff, 16, 1024),
                      ks > 0 ? 1u : 0u);
    }
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::kDqQBox + (ks % 4) * 32u;
      const uint32_t koff = s * T::kDqKVBytes + (ks / 4) * T::kDqKVBox + (ks % 4) * 32u;
      GmmaSS<BK>::run(dp, gmma_desc(oa + off, 16, 1024), gmma_desc(sV + koff, 16, 1024),
                      ks > 0 ? 1u : 0u);
    }
  };
  // dQ += dS K from stage s (K MN-major: LBO the next 64 columns' box, SBO
  // the next 8 keys; a 16-key step is 2048 bytes)
  auto issue_rs = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      GmmaRS<DV>::run(dq, dsf[kk], gmma_desc(sK + s * T::kDqKVBytes + kk * 2048, T::kDqKVBox, 1024));
  };

  // this thread's two query rows of tile jj: their LSE (+inf past Lq:
  // P = 0) and Delta, read a tile ahead
  auto row_stats = [&](int jj) {
    const int r = (j0 + jj) * T::kDqQ + cw * 64 + warp * 16 + g;
    return make_float4(r < p.Lq ? p.lse[stats + r] : INFINITY,
                       r + 8 < p.Lq ? p.lse[stats + r + 8] : INFINITY,
                       r < p.Lq ? p.delta[stats + r] : 0.f,
                       r + 8 < p.Lq ? p.delta[stats + r + 8] : 0.f);
  };
  float4 next = row_stats(0);
  int it = 0;  // K/V tiles consumed so far
  for (int jj = 0; jj < p.tiles; ++jj) {
    const int qb = jj % QB;
    const int row0 = (j0 + jj) * T::kDqQ + cw * 64 + warp * 16 + g;  // and row0 + 8
    const float lse0 = next.x, lse1 = next.y, dd0 = next.z, dd1 = next.w;
    if (jj + 1 < p.tiles) next = row_stats(jj + 1);
    const uint32_t qa = sQ + qb * T::kDqQBytes + cw * 64 * 128;
    const uint32_t oa = sO + qb * T::kDqQBytes + cw * 64 * 128;
    zero_acc(dq);
    mbar_wait(q_full(qb), (jj / QB) & 1);
    if (pad) {
      zero_chunk_rows(qa + T::kPadBox * T::kDqQBox, T::kChunk, 64, tid, 128);
      zero_chunk_rows(oa + T::kPadBox * T::kDqQBox, T::kChunk, 64, tid, 128);
      fence_proxy_async();
      wg_sync();
    }
    // P = exp2(s scale log2 e + bias - lse) and dS = P (dP - Delta) for
    // this thread's rows and keys (columns 8 i + 2 tg + {0, 1}); without a
    // bias, keys past Lk are masked here
    auto elementwise = [&](int t, int s) {
      const int k0 = t * BK;
      const float* bt = bias_tiles ? bias_tiles + s * BK : nullptr;
      const bool ragged = bt == nullptr && k0 + BK > p.Lk;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        float2 bv = make_float2(0.f, 0.f);
        if (bt != nullptr) {
          bv = *reinterpret_cast<const float2*>(bt + i * 8 + tg4 * 2);
        } else if (ragged) {
          const int key = k0 + i * 8 + tg4 * 2;
          bv.x = key < p.Lk ? 0.f : -INFINITY;
          bv.y = key + 1 < p.Lk ? 0.f : -INFINITY;
        }
        const float p0 = fast_exp2(fmaf(sc[i][0], p.scale_log2, bv.x - lse0));
        const float p1 = fast_exp2(fmaf(sc[i][1], p.scale_log2, bv.y - lse0));
        const float p2 = fast_exp2(fmaf(sc[i][2], p.scale_log2, bv.x - lse1));
        const float p3 = fast_exp2(fmaf(sc[i][3], p.scale_log2, bv.y - lse1));
        sc[i][0] = p0 * (dp[i][0] - dd0);
        sc[i][1] = p1 * (dp[i][1] - dd0);
        sc[i][2] = p2 * (dp[i][2] - dd1);
        sc[i][3] = p3 * (dp[i][3] - dd1);
      }
    };

    // the first key tile: its SS products only
    wait_kv(it, !resident || jj == 0);
    turn_begin();
    issue_ss(qa, oa, it % ST);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(sc);
    gmma_fence_regs(dp);
    elementwise(0, it % ST);
    if (!resident) release(v_empty(it % ST));
    pack_a<KT>(dsf, sc);
    // key tile t: its SS products with t - 1's dS K in one turn, then its
    // elementwise work while dS K runs; V_t is free after dP_t, K_{t-1}
    // after dS_{t-1} K_{t-1}
    for (int t = 1; t < nkv; ++t) {
      const int i = it + t, s = i % ST, sp = (i - 1) % ST;
      wait_kv(i, true);
      turn_begin();
      issue_ss(qa, oa, s);
      gmma_commit();
      issue_rs(sp);
      gmma_commit();
      turn_end();
      gmma_wait<1>();
      gmma_fence_regs(sc);
      gmma_fence_regs(dp);
      elementwise(t, s);
      release(v_empty(s));
      gmma_wait<0>();
      gmma_fence_regs(dq);
      release(k_empty(sp));
      pack_a<KT>(dsf, sc);
    }
    // the last dS K
    const int sl = (it + nkv - 1) % ST;
    turn_begin();
    issue_rs(sl);
    gmma_commit();
    turn_end();
    gmma_wait<0>();
    gmma_fence_regs(dq);
    if (!resident) release(k_empty(sl));
    // Q and dO of this query tile are no longer read
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty(qb));
    if (!resident) it += nkv;

    const long long base = (long long)b * p.Lq * C + (long long)h * p.D;
    if (p.out_f32)
      store_scaled<float, DT>(static_cast<float*>(p.out0) + base, C, dq, p.scale, p.scale, row0,
                              p.Lq, 0, p.D, tg4);
    else
      store_scaled<bf16, DT>(static_cast<bf16*>(p.out0) + base, C, dq, p.scale, p.scale, row0,
                             p.Lq, 0, p.D, tg4);
  }
  // the other warpgroup's last hand-over, which no turn waits for
  if (cw == 0) named_sync(kBarTurn + 0, 2 * 128);
  cluster_sync();  // no peer arrives on this CTA's barriers after it exits
}

// ---- host ----

// The plan's integers (ops/flash.py: _bwd_cfg), in this order.
enum Cfg {
  kCfgB, kCfgH, kCfgLq, kCfgLk, kCfgD, kCfgLqp, kCfgBiasSb, kCfgSplitStride, kCfgWide,
  kCfgBlockQ, kCfgBlockK, kCfgStages, kCfgTiles, kCfgGridX, kCfgExtra, kCfgLen
};

struct Launch {
  const void *q, *k, *v, *g;
  const long long* maps;  // q, k, v, dO: 4 extents and 3 byte strides each
  const long long* cfg;
};

bool encode_maps(CUtensorMap (&m)[4], const Launch& a, int q_rows, int kv_rows) {
  return encode_map(&m[0], a.q, a.maps, a.maps + 4, q_rows) &&
         encode_map(&m[1], a.k, a.maps + 7, a.maps + 11, kv_rows) &&
         encode_map(&m[2], a.v, a.maps + 14, a.maps + 18, kv_rows) &&
         encode_map(&m[3], a.g, a.maps + 21, a.maps + 25, q_rows);
}

template <int DQK, int DV>
cudaError_t launch_dkv(const Launch& a, const BwdParams& p, cudaStream_t stream) {
  using T = Tiles<DQK, DV>;
  const long long* c = a.cfg;
  if (c[kCfgBlockQ] != T::kDkvQ || c[kCfgBlockK] != T::kDkvKeys ||
      c[kCfgStages] != T::kDkvStages)
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!encode_maps(m, a, T::kDkvQ, T::kDkvKeys)) return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_sm90_kernel<DQK, DV>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, T::kDkvSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)c[kCfgGridX], p.H, (unsigned)c[kCfgB]);
  kern<<<grid, kThreads, T::kDkvSmem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

template <int DQK, int DV, int BKQ>
cudaError_t launch_dq(const Launch& a, const BwdParams& p, cudaStream_t stream) {
  using T = Tiles<DQK, DV, BKQ>;
  const long long* c = a.cfg;
  if (c[kCfgBlockQ] != T::kDqQ || c[kCfgBlockK] != T::kDqK || c[kCfgStages] != T::kDqStages ||
      c[kCfgExtra] != T::kDqQBufs || c[kCfgGridX] % kCluster != 0)
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!encode_maps(m, a, T::kDqQ, T::kDqK / kCluster)) return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_sm90_kernel<DQK, DV, BKQ>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, T::kDqSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)c[kCfgGridX], p.H, (unsigned)c[kCfgB]);
  kern<<<grid, kThreads, T::kDqSmem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

// The dQ pass at d <= 64 also has 32-key tiles, for key lengths up to 32
// (the audio and identity cross-attention): a 128-key tile would compute
// three quarters of its scores for keys past Lk.
template <int DQK, int DV>
cudaError_t launch_dq_any(const Launch& a, const BwdParams& p, cudaStream_t stream) {
  if constexpr (DV <= 64) {
    if (a.cfg[kCfgBlockK] == 32) return launch_dq<DQK, DV, 32>(a, p, stream);
  }
  return launch_dq<DQK, DV, 0>(a, p, stream);
}

#define K5_CASE(DV)                                                       \
  case DV:                                                                \
    return dq_pass ? launch_dq_any<((DV) + 15) / 16 * 16, DV>(a, p, st)   \
                   : launch_dkv<((DV) + 15) / 16 * 16, DV>(a, p, st);

cudaError_t dispatch(bool dq_pass, const Launch& a, const BwdParams& p, cudaStream_t st) {
  switch (p.D) {
    K5_CASE(8) K5_CASE(16) K5_CASE(24) K5_CASE(32) K5_CASE(40)
    K5_CASE(48) K5_CASE(56) K5_CASE(64) K5_CASE(72) K5_CASE(80)
    K5_CASE(88) K5_CASE(96) K5_CASE(104) K5_CASE(112) K5_CASE(120)
    K5_CASE(128) K5_CASE(136) K5_CASE(144) K5_CASE(152) K5_CASE(160)
    default:
      return cudaErrorInvalidValue;
  }
}

#undef K5_CASE

int run(bool dq_pass, const void* q, const void* k, const void* v, const void* g,
        const void* bias, const void* lse, const void* delta, void* out0, void* out1,
        const long long* maps, const long long* cfg, int out_f32, float scale,
        float scale_log2, void* stream) {
  const int D = (int)cfg[kCfgD];
  if (D <= 0 || D % 8 != 0 || D > 160 || cfg[kCfgLq] <= 0 || cfg[kCfgLk] <= 0 ||
      cfg[kCfgB] <= 0 || cfg[kCfgH] <= 0 || cfg[kCfgTiles] <= 0 || cfg[kCfgGridX] <= 0 ||
      cfg[kCfgLqp] % 64 != 0 || cfg[kCfgLqp] < cfg[kCfgLq])
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.H = (int)cfg[kCfgH];
  p.Lq = (int)cfg[kCfgLq];
  p.Lk = (int)cfg[kCfgLk];
  p.D = D;
  p.Lqp = (int)cfg[kCfgLqp];
  p.bias_sb = cfg[kCfgBiasSb];
  p.split_stride = cfg[kCfgSplitStride];
  p.scale = scale;
  p.scale_log2 = scale_log2;
  p.out_f32 = out_f32;
  p.wide = (int)cfg[kCfgWide];
  p.tiles = (int)cfg[kCfgTiles];
  p.wg_split = dq_pass ? 0 : (int)cfg[kCfgExtra];
  const Launch a{q, k, v, g, maps, cfg};
  return (int)dispatch(dq_pass, a, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

// bf16 q, k, v, dO (g) through their tensor maps (`maps`: 7 values each, as
// ops/flash.py's bwd_plan gives them); bias: the tiled per-key bias or
// null; lse and delta: fp32 (B, H, Lqp); the outputs (B, L, C) contiguous,
// bf16 or fp32 (`out_f32`). `cfg`: the plan's integers (enum Cfg).
extern "C" int hallo_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                        const void* g, const void* bias, const void* lse,
                                        const void* delta, void* dk, void* dv,
                                        const long long* maps, const long long* cfg,
                                        int out_f32, float scale, float scale_log2,
                                        void* stream) {
  return run(false, q, k, v, g, bias, lse, delta, dk, dv, maps, cfg, out_f32, scale,
             scale_log2, stream);
}

extern "C" int hallo_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                       const void* g, const void* bias, const void* lse,
                                       const void* delta, void* dq, void* unused,
                                       const long long* maps, const long long* cfg,
                                       int out_f32, float scale, float scale_log2,
                                       void* stream) {
  return run(true, q, k, v, g, bias, lse, delta, dq, unused, maps, cfg, out_f32, scale,
             scale_log2, stream);
}
