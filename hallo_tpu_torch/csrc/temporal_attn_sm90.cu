// K2 for Hopper (sm_90a): frame-axis (temporal) self-attention with TMA
// loads into a ring, tensor-core products and a producer warp.
//
// Replaces hallo_tpu/ops/pallas_temporal.py:42 `_temporal_kernel` (reached
// through `temporal_attention`, :322) and serves :104
// `_temporal_kernel_packed` (K7, through `temporal_attention_packed`, :242),
// whose natural (B, F, L, C = H d) layout it takes: at every site l and
// head h, o[f] = softmax over g of (q_f . k_g * scale) v_g over the F <= 32
// frames; bf16 in and out, scores and softmax in fp32 in the exp2 domain,
// the probabilities rounded to bf16 for the PV product (as the plain
// versions of both packages do).
//
// What bounds it on this card: bytes. q, k and v are read once and o is
// written once: 377 MB at level 0 of the 512^2 denoiser (B 2, F 18, L 4096,
// C 320), 0.113 ms at 3.35 TB/s; the products are 3.4 GFLOP there, tens of
// microseconds on the tensor cores even with the frames padded.
//
// The first port of it (CUDA cores) ran at 3.2x that bound, held back three ways.
// What this design does about each:
// 1. Compute: its F x F x d products were fp32 FMAs fed by 32-bit shared
//    loads and bf16 conversions. Here a warp takes one (site, head) task on
//    the tensor cores: S = Q K^T by mma.sync m16n8k16 over d (m16n8k8 for
//    the last 8 columns when d % 16 = 8, so the contraction reads exactly
//    the head's d columns), queries in one or two 16-row tiles, keys in
//    8-wide tiles; the softmax on the accumulator registers (a row's keys
//    sit in the 4 lanes of a quad); P normalised and repacked to bf16 A
//    fragments for O = P V (m16n8k16, keys padded to 16 or 32). Operands
//    come from shared memory by ldmatrix (V transposed), the next 16
//    columns' fragments loading while this step's products run; the output
//    goes back by stmatrix.
// 2. No pipelining: it loaded a tile through registers, computed, then
//    stored, with two __syncthreads between. Here the grid is persistent
//    (one CTA an SM walking (batch, site tile, head group) units), and one
//    producer thread keeps a ring of `stages` units in flight by TMA (one
//    4-d map per operand over (C, F, L, B), boxes of 64 columns x F frames x
//    T sites, 128-byte swizzle) while 12 consumer warps (8 at F > 24, for
//    the registers of 4 key tiles) compute on the landed ones: full
//    barriers carry the TMA bytes, empty barriers one arrival per consumer
//    warp, and every consumer waits on every phase of every stage (the
//    tasks of a unit are dealt to all warps, rotating from unit to unit).
// 3. Frame counts other than 16 and 18 took a run-time path 1.6x slower.
//    Here F is a run-time value: queries pad to 16 or 32 rows, keys to 8-key
//    tiles (one instantiation per tile count, 1-4) and to 16 or 32 for PV.
//
// Pads and neighbours: a unit's columns are whole 64-column boxes over a
// group of heads (8 heads of d 40, 4 of 80, 2 of 160: 320 columns, each
// byte read once). A task reads only its head's d columns, so no value of
// another head (not even an inf) reaches it, and no pad column is zeroed.
// Rows of frames >= F (query rows past F, keys past F in S and in PV) are
// read from a 16-byte zero row instead of the tile, so 0 x inf never arises,
// and keys >= F are masked to -inf before the softmax. A task's output goes
// over its own Q rows and columns in shared memory (read by nothing else;
// rows past F to a trash row), then to global memory with 16-byte stores of
// exactly its F rows and d columns, so no CTA writes another's output.
//
// Bank conflicts: a box row is 128 bytes and the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) (the swizzle TMA applies), so the 8 rows that
// one ldmatrix or stmatrix phase touches (8 consecutive frames of one site)
// fall on 8 distinct chunks.
//
// The host encodes the three tensor maps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, no -lcuda); the maps' extents and the
// unit geometry (heads a unit, sites, boxes, rows a box, stages, grid) come
// from the wrapper (ops/temporal.py: temporal_plan), which is cached by
// shape.

#include <cuda.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// Consumer warps (one more warp is the producer): 12, or 8 with 4 key tiles,
// whose scores need the registers (ptxas then keeps every instantiation
// spill-free).
__host__ __device__ constexpr int consumer_warps(int key_tiles) { return key_tiles == 4 ? 8 : 12; }
constexpr int kSmemMax = 232448;  // what a block may use on an H100
constexpr int kMaxFrames = 32;    // the temporal positional encoding's limit

struct TemporalParams {
  bf16* o;
  int F, L, H, D;
  int NH;         // heads a unit
  int G;          // head groups: ceil(H / NH)
  int T;          // sites a unit
  int tiles;      // site tiles: ceil(L / T)
  int NB;         // 64-column boxes per operand and unit
  int box_bytes;  // one box's buffer: rows (F T rounded up to 8) x 128
  int stages;
  int units;
  long long o_sb, o_sf, o_sl;  // o's element strides
  float scale_log2;            // softmax scale * log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// D(16x8, f32) += A(16x8, bf16) B(8x8, bf16): the contraction's last 8
// columns when d % 16 = 8.
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void stsm_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n"
               ::"r"(addr), "r"(r0), "r"(r1)
               : "memory");
}

// The 16-byte chunk that holds column `col` (a multiple of 8) of row r of
// an operand's tile at `base`: box col / 64, chunk (col % 64) / 8 swizzled
// with the row (each box buffer is 1024-byte aligned).
__device__ __forceinline__ uint32_t chunk_addr(uint32_t base, int box_bytes, int r, int col) {
  return base + (col >> 6) * box_bytes + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4);
}

// A lane's row of a tile for ldmatrix / stmatrix: its first byte in the
// operand's first box and its swizzle phase; a frame past F reads the zero
// row (or writes the trash row) instead.
struct Row {
  uint32_t at;
  int x;
  bool in;
};

__device__ __forceinline__ Row tile_row(uint32_t base, int r, bool in) {
  return Row{base + r * 128, r & 7, in};
}

__device__ __forceinline__ uint32_t at_col(const Row& w, int box_bytes, int col, uint32_t other) {
  return w.in ? w.at + (col >> 6) * box_bytes + ((((col >> 3) & 7) ^ w.x) << 4) : other;
}

// KT: 8-key tiles of S (ceil(F / 8)); a site's queries take MT 16-row tiles.
template <int KT>
__global__ void __launch_bounds__(32 * (consumer_warps(KT) + 1), 1)
    temporal_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const TemporalParams p) {
  constexpr int kWarps = consumer_warps(KT);
  constexpr int MT = KT > 2 ? 2 : 1;
  constexpr int KS = (KT + 1) / 2;  // 16-key steps of O = P V
  constexpr int KP = KT / 2;        // pairs of key tiles (one ldmatrix.x4 each)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int op_bytes = p.NB * p.box_bytes;  // one operand's tile
  const int stage_bytes = 3 * op_bytes;     // Q, K, V
  const uint32_t bars = base + p.stages * stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };
  const uint32_t zero_row = bars + 16 * p.stages;  // 16 bytes of zeros
  const uint32_t trash_row = zero_row + 16;        // where rows past F are stored
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);
    }
    mbar_init_fence();
  }
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem_raw + (zero_row - raw))[threadIdx.x] = 0u;
  __syncthreads();

  // unit u: head group fastest, then site tile, then batch
  auto decode = [&](int u, int& b, int& l0, int& g) {
    g = u % p.G;
    const int r = u / p.G;
    l0 = (r % p.tiles) * p.T;
    b = r / p.tiles;
  };

  if (warp == kWarps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      const uint32_t tx = 3u * p.NB * 128u * p.F * p.T;
      for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
        const int s = i % p.stages;
        // the stage's previous unit (i - stages) released by every consumer warp
        if (i >= p.stages) mbar_wait(empty(s), ((i / p.stages) + 1) & 1);
        int b, l0, g;
        decode(u, b, l0, g);
        const int col0 = ((g * p.NH * p.D) >> 6) << 6;  // the window's first column
        const uint32_t sq = base + s * stage_bytes;
        mbar_expect_tx(full(s), tx);
        for (int j = 0; j < p.NB; ++j) {
          const uint32_t at = sq + j * p.box_bytes;
          tma_load_4d(at, &tq, full(s), col0 + 64 * j, 0, l0, b);
          tma_load_4d(at + op_bytes, &tk, full(s), col0 + 64 * j, 0, l0, b);
          tma_load_4d(at + 2 * op_bytes, &tv, full(s), col0 + 64 * j, 0, l0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: a task is one (site, head); warp w takes the tasks j of
  // a unit with (j + rot) % kWarps == w, rot advancing by a unit's tasks ----
  const int F = p.F, D = p.D, box = p.box_bytes;
  const int tg = lane & 3;
  const int d16 = D >> 4;
  const int tasks = p.T * p.NH;
  const float scale = p.scale_log2;
  int rot = 0;
  for (int i = 0, u = blockIdx.x; u < p.units; ++i, u += gridDim.x) {
    const int s = i % p.stages;
    int b, l0, g;
    decode(u, b, l0, g);
    const int nh = min(p.NH, p.H - g * p.NH);  // the last group may be partial
    const int col0 = ((g * p.NH * p.D) >> 6) << 6;
    const uint32_t sq = base + s * stage_bytes, sk = sq + op_bytes, sv = sk + op_bytes;
    mbar_wait(full(s), (i / p.stages) & 1);
    for (int j = ((warp - rot) % kWarps + kWarps) % kWarps; j < tasks; j += kWarps) {
      const int hl = j % p.NH, t = j / p.NH;
      const int l = l0 + t;
      if (hl >= nh || l >= p.L) continue;
      const int head = g * p.NH + hl;
      const int c0 = head * D - col0;  // the head's first column in the window
      const int rb = t * F;            // frame 0 of this site, in every box

      // Lanes' rows. A operand (Q; also the output's stmatrix rows): rows,
      // then the column half. B operand (K): keys, then the column half, a
      // pair of 8-key tiles an ldmatrix.x4 (the odd last tile an .x2).
      Row qr[MT], kr[KP + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int f = 16 * m + (lane & 7) + ((lane >> 3) & 1) * 8;
        qr[m] = tile_row(sq, rb + f, f < F);
      }
#pragma unroll
      for (int pp = 0; pp <= KP; ++pp) {
        const int key = pp < KP ? 16 * pp + ((lane >> 4) & 1) * 8 + (lane & 7)
                                : 8 * (KT - 1) + (lane & 7);
        kr[pp] = tile_row(sk, rb + key, key < F);
      }
      const int qcol = c0 + (lane >> 4) * 8, kcol = c0 + ((lane >> 3) & 1) * 8;

      // ---- S = Q K^T over the head's d columns, 16 at a time; the next
      // step's fragments load while this step's products run ----
      float sc[MT][KT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < KT; ++n) sc[m][n][0] = sc[m][n][1] = sc[m][n][2] = sc[m][n][3] = 0.f;
      struct Frag {
        uint32_t a[MT][4];
        uint32_t b[2 * KT];
      };
      auto load = [&](Frag& fr, int k0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(fr.a[m], at_col(qr[m], box, qcol + k0, zero_row));
#pragma unroll
        for (int pp = 0; pp < KP; ++pp) {
          uint32_t r4[4];
          ldsm_x4(r4, at_col(kr[pp], box, kcol + k0, zero_row));
#pragma unroll
          for (int e = 0; e < 4; ++e) fr.b[4 * pp + e] = r4[e];
        }
        if (KT & 1) {
          uint32_t r2[2];
          ldsm_x2(r2, at_col(kr[KP], box, kcol + k0, zero_row));
          fr.b[4 * KP] = r2[0];
          fr.b[4 * KP + 1] = r2[1];
        }
      };
      auto products = [&](const Frag& fr) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < KT; ++n) mma_bf16(sc[m][n], fr.a[m], fr.b[2 * n], fr.b[2 * n + 1]);
      };
      if (d16 > 0) {
        Frag f0, f1;
        load(f0, 0);
        for (int ks = 0;;) {
          if (ks + 1 < d16) load(f1, 16 * (ks + 1));
          products(f0);
          if (++ks == d16) break;
          if (ks + 1 < d16) load(f0, 16 * (ks + 1));
          products(f1);
          if (++ks == d16) break;
        }
      }
      if (D & 8) {
        const int k0 = 16 * d16;
        uint32_t a[MT][2], bb[4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int f = 16 * m + (lane & 15);
          ldsm_x2(a[m], f < F ? chunk_addr(sq, box, rb + f, c0 + k0) : zero_row);
        }
        // matrix n: keys 8 n .. 8 n + 7 (lane = key)
        ldsm_x4(bb, lane < F ? chunk_addr(sk, box, rb + lane, c0 + k0) : zero_row);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < KT; ++n) mma_k8(sc[m][n], a[m][0], a[m][1], bb[n]);
      }

      // ---- softmax over the keys of rows g and g + 8 of each query tile
      // (a row's keys sit in the 4 lanes of a quad); keys >= F at -inf ----
      float mx[MT][2], sum[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mx[m][0] = mx[m][1] = -INFINITY;
#pragma unroll
        for (int n = 0; n < KT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool in = 8 * n + 2 * tg + c < F;
            sc[m][n][c] = in ? sc[m][n][c] * scale : -INFINITY;
            sc[m][n][c + 2] = in ? sc[m][n][c + 2] * scale : -INFINITY;
            mx[m][0] = fmaxf(mx[m][0], sc[m][n][c]);
            mx[m][1] = fmaxf(mx[m][1], sc[m][n][c + 2]);
          }
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mx[m][0] = fmaxf(mx[m][0], __shfl_xor_sync(0xffffffffu, mx[m][0], sh));
          mx[m][1] = fmaxf(mx[m][1], __shfl_xor_sync(0xffffffffu, mx[m][1], sh));
        }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        sum[m][0] = sum[m][1] = 0.f;
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          sc[m][n][0] = fast_exp2(sc[m][n][0] - mx[m][0]);
          sc[m][n][1] = fast_exp2(sc[m][n][1] - mx[m][0]);
          sc[m][n][2] = fast_exp2(sc[m][n][2] - mx[m][1]);
          sc[m][n][3] = fast_exp2(sc[m][n][3] - mx[m][1]);
          sum[m][0] += sc[m][n][0] + sc[m][n][1];
          sum[m][1] += sc[m][n][2] + sc[m][n][3];
        }
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          sum[m][0] += __shfl_xor_sync(0xffffffffu, sum[m][0], sh);
          sum[m][1] += __shfl_xor_sync(0xffffffffu, sum[m][1], sh);
        }
      // P, normalised, as bf16 A fragments of the 16-key steps (keys past
      // the last 8-key tile are 0)
      uint32_t pf[MT][KS][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float i0 = 1.f / sum[m][0], i1 = 1.f / sum[m][1];
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          pf[m][k][0] = pack_bf16(sc[m][2 * k][0] * i0, sc[m][2 * k][1] * i0);
          pf[m][k][1] = pack_bf16(sc[m][2 * k][2] * i1, sc[m][2 * k][3] * i1);
          if (2 * k + 1 < KT) {
            pf[m][k][2] = pack_bf16(sc[m][2 * k + 1][0] * i0, sc[m][2 * k + 1][1] * i0);
            pf[m][k][3] = pack_bf16(sc[m][2 * k + 1][2] * i1, sc[m][2 * k + 1][3] * i1);
          } else {
            pf[m][k][2] = pf[m][k][3] = 0u;
          }
        }
      }

      // ---- O = P V, 16 columns at a time (V^T fragments: keys, then the
      // column tile), stored by stmatrix over this task's own Q rows; the
      // next 16 columns' fragments load while these products run ----
      Row vr[KS];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int key = 16 * k + ((lane >> 3) & 1) * 8 + (lane & 7);
        vr[k] = tile_row(sv, rb + key, key < F);
      }
      struct VFrag {
        uint32_t b[KS][4];
      };
      auto vload = [&](VFrag& fr, int k0) {
#pragma unroll
        for (int k = 0; k < KS; ++k) ldsm_x4_t(fr.b[k], at_col(vr[k], box, qcol + k0, zero_row));
      };
      auto vproducts = [&](const VFrag& fr, int k0) {
        float acc[MT][2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][0], pf[m][k], fr.b[k][0], fr.b[k][1]);
            mma_bf16(acc[m][1], pf[m][k], fr.b[k][2], fr.b[k][3]);
          }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          stsm_x4(at_col(qr[m], box, qcol + k0, trash_row), pack_bf16(acc[m][0][0], acc[m][0][1]),
                  pack_bf16(acc[m][0][2], acc[m][0][3]), pack_bf16(acc[m][1][0], acc[m][1][1]),
                  pack_bf16(acc[m][1][2], acc[m][1][3]));
      };
      if (d16 > 0) {
        VFrag v0, v1;
        vload(v0, 0);
        for (int pp = 0;;) {
          if (pp + 1 < d16) vload(v1, 16 * (pp + 1));
          vproducts(v0, 16 * pp);
          if (++pp == d16) break;
          if (pp + 1 < d16) vload(v0, 16 * (pp + 1));
          vproducts(v1, 16 * pp);
          if (++pp == d16) break;
        }
      }
      if (D & 8) {  // the last 8 columns: one tile (lanes 0-15 give the rows)
        const int k0 = 16 * d16;
        float acc[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t bb[2];
          ldsm_x2_t(bb, at_col(vr[k], box, c0 + k0, zero_row));
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[m], pf[m][k], bb[0], bb[1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          stsm_x2(at_col(qr[m], box, c0 + k0, trash_row), pack_bf16(acc[m][0], acc[m][1]),
                  pack_bf16(acc[m][2], acc[m][3]));
      }
      __syncwarp();

      // ---- the site's F rows of exactly d columns to o, 16-byte stores,
      // four in flight a lane ----
      const int cpr = D >> 3, total = F * cpr;
      const int step_r = 32 / cpr, step_c = 32 - step_r * cpr;
      int rr = lane / cpr, cc = lane - rr * cpr;
      bf16* ob = p.o + b * p.o_sb + l * p.o_sl + head * D;
      for (int x = lane; x < total; x += 128) {
        uint4 val[4];
        long long at[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + 32 * e < total) {
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(val[e].x), "=r"(val[e].y), "=r"(val[e].z), "=r"(val[e].w)
                         : "r"(chunk_addr(sq, box, rb + rr, c0 + 8 * cc))
                         : "memory");
            at[e] = rr * p.o_sf + 8 * cc;
          }
          cc += step_c;
          rr += step_r;
          if (cc >= cpr) {
            cc -= cpr;
            ++rr;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x + 32 * e < total) *reinterpret_cast<uint4*>(ob + at[e]) = val[e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    rot = (rot + tasks) % kWarps;
  }
}

// ---- host ----

template <int KT>
cudaError_t launch(const void* q, const void* k, const void* v, const long long* maps,
                   const TemporalParams& p, int grid, int smem, cudaStream_t stream) {
  const cuuint64_t dims[4] = {(cuuint64_t)maps[0], (cuuint64_t)maps[1], (cuuint64_t)maps[2],
                              (cuuint64_t)maps[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)maps[4], (cuuint64_t)maps[5], (cuuint64_t)maps[6]};
  const cuuint32_t box[4] = {64, (cuuint32_t)p.F, (cuuint32_t)p.T, 1};
  CUtensorMap tq, tk, tv;
  if (!encode_tiled(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tiled(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, k, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tiled(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = temporal_sm90_kernel<KT>;
  static unsigned long long configured = 0;
  cudaError_t err = configure_once(kern, kSmemMax, configured);
  if (err != cudaSuccess) return err;
  kern<<<grid, 32 * (consumer_warps(KT) + 1), smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (B, F, L, H D) bf16. `args`: ops/temporal.py's
// _launch_args of temporal_plan, 19 values: the operands' tensor map (the
// extents C, F, L, B, then the byte strides of F, L, B); H, D; a unit's
// heads and sites; its 64-column boxes an operand and each box buffer's
// rows (of 128 bytes); the ring's stages; the grid; the consumer warps
// (checked against the instantiation); o's element strides of B, F, L.
extern "C" int hallo_temporal_attn_sm90(const void* q, const void* k, const void* v, void* o,
                                        const long long* args, float scale_log2, void* stream) {
  const long long* maps = args;
  const int B = (int)args[3], F = (int)args[1], L = (int)args[2], H = (int)args[7],
            D = (int)args[8], heads_per_unit = (int)args[9], sites = (int)args[10],
            boxes = (int)args[11], box_rows = (int)args[12], stages = (int)args[13],
            grid = (int)args[14], warps = (int)args[15];
  if (B <= 0 || F <= 0 || F > kMaxFrames || L <= 0 || H <= 0 || D <= 0 || D % 8 != 0 ||
      heads_per_unit <= 0 || heads_per_unit > H || sites <= 0 || sites > 256 || boxes <= 0 ||
      box_rows % 8 != 0 || box_rows < F * sites || stages <= 0 || grid <= 0 ||
      warps != consumer_warps((F + 7) / 8) || maps[0] != (long long)H * D)
    return (int)cudaErrorInvalidValue;
  TemporalParams p;
  p.o = static_cast<bf16*>(o);
  p.F = F; p.L = L; p.H = H; p.D = D;
  p.NH = heads_per_unit;
  p.G = (H + heads_per_unit - 1) / heads_per_unit;
  p.T = sites;
  p.tiles = (L + sites - 1) / sites;
  p.NB = boxes;
  p.box_bytes = box_rows * 128;
  p.stages = stages;
  const long long units = (long long)B * p.tiles * p.G;
  if (units > 0x7fffffff || grid > units) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  p.o_sb = args[16]; p.o_sf = args[17]; p.o_sl = args[18];
  p.scale_log2 = scale_log2;
  // the ring, the barriers, the zero and trash rows, the 1024-byte alignment slack
  const long long smem = (long long)stages * 3 * boxes * p.box_bytes + 16LL * stages + 32 + 1024;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((F + 7) / 8) {
    case 1: return (int)launch<1>(q, k, v, maps, p, grid, (int)smem, st);
    case 2: return (int)launch<2>(q, k, v, maps, p, grid, (int)smem, st);
    case 3: return (int)launch<3>(q, k, v, maps, p, grid, (int)smem, st);
    default: return (int)launch<4>(q, k, v, maps, p, grid, (int)smem, st);
  }
}
