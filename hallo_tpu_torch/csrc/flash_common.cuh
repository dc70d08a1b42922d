// Device code shared by the hand-written attention kernels for Hopper
// (sm_90a): fast_exp2 and pack_bf16; the normalised store of an output
// held in the mma/wgmma accumulator layout (flash_fwd_sm90.cu, K1;
// flash_fwd_d512_sm90.cu, K4; flash_fwd_t_sm90.cu, K3; flash_int8_sm90.cu,
// K6; flash_bwd_sm90.cu, K5, takes store_scaled) and the base-2 online
// softmax of a key tile in that layout (`tile_softmax`, K1, K3, K4, K6);
// mma.sync m16n8k16 in bf16 (temporal_attn_sm90.cu, K2).
//
// The layout: one warp per 16 rows, lane (g = lane / 4, tg = lane % 4)
// holding rows g and g + 8 of each 8-column tile at columns 2 tg and
// 2 tg + 1 (e = 0, 1 for row g; e = 2, 3 for row g + 8) -- mma.sync's m16n8
// accumulator, and wgmma's for each 8 columns.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Store the columns col0 + 8 dt + 2 tg (< D) of rows row0 and row0 + 8 that
// this lane holds in `acc`, times mul0 and mul1, in T, rows with stride s_l;
// rows >= L are dropped.
template <typename T, int DTILES>
__device__ __forceinline__ void store_scaled(T* ob, long long s_l, const float (&acc)[DTILES][4],
                                             float mul0, float mul1, int row0, int L,
                                             int col0, int D, int tg) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = col0 + dt * 8 + tg * 2;
    if (col < D) {
      if constexpr (sizeof(T) == 4) {
        if (row0 < L)
          *reinterpret_cast<float2*>(ob + (long long)row0 * s_l + col) =
              make_float2(acc[dt][0] * mul0, acc[dt][1] * mul0);
        if (row1 < L)
          *reinterpret_cast<float2*>(ob + (long long)row1 * s_l + col) =
              make_float2(acc[dt][2] * mul1, acc[dt][3] * mul1);
      } else {
        if (row0 < L)
          *reinterpret_cast<uint32_t*>(ob + (long long)row0 * s_l + col) =
              pack_bf16(acc[dt][0] * mul0, acc[dt][1] * mul0);
        if (row1 < L)
          *reinterpret_cast<uint32_t*>(ob + (long long)row1 * s_l + col) =
              pack_bf16(acc[dt][2] * mul1, acc[dt][3] * mul1);
      }
    }
  }
}

// Sum a row's quad-partial value over the 4 lanes of its quad.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Normalise rows row0 and row0 + 8 by their quad-reduced l (a row whose keys
// were all masked gets 0) and store them (see store_scaled).
template <typename T, int DTILES>
__device__ __forceinline__ void store_rows(T* ob, long long s_l, const float (&acc)[DTILES][4],
                                           const float (&l_r)[2], int row0, int Lq,
                                           int col0, int D, int tg) {
  const float l0 = quad_sum(l_r[0]), l1 = quad_sum(l_r[1]);
  store_scaled<T, DTILES>(ob, s_l, acc, l0 > 0.f ? 1.f / l0 : 0.f, l1 > 0.f ? 1.f / l1 : 0.f,
                          row0, Lq, col0, D, tg);
}

// The max over a thread's columns of one row (e0 = 0: row g, 2: row g + 8)
// in 4 independent chains: a consumer warp shares its scheduler with one or
// two others, so a single chain's latency would stall it.
template <int KT>
__device__ __forceinline__ float row_max(const float (&s)[KT][4], int e0) {
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KT; ++i) m[i & 3] = fmaxf(m[i & 3], fmaxf(s[i][e0], s[i][e0 + 1]));
  return fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
}

// One key tile's online softmax for rows g and g + 8 of a warp, in the log2
// domain: x = s * scale (+ the tile's bias, already times log2 e and -inf
// past Lk; without one, -inf for keys >= Lk). `s` holds the raw scores and
// receives the unnormalised probabilities exp2(x - m); m_r is the running
// max of x, l_r the quad-partial row sums (reduced at the store); alpha
// receives the factor that rescales the output so far. A tile with no bias
// and no key past Lk takes x = s * scale inside the ex2's argument (one
// FFMA a score); a row with every key at -inf keeps m = -inf and gets p = 0.
template <int KT>
__device__ __forceinline__ void tile_softmax(float (&s)[KT][4], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], float scale, const float* bias,
                                             int k0, int lk, int tg) {
  float mul = scale;
  if (bias != nullptr) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + i * 8 + tg * 2);
      s[i][0] = fmaf(s[i][0], scale, bv.x);
      s[i][1] = fmaf(s[i][1], scale, bv.y);
      s[i][2] = fmaf(s[i][2], scale, bv.x);
      s[i][3] = fmaf(s[i][3], scale, bv.y);
    }
    mul = 1.f;
  } else if (k0 + KT * 8 > lk) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = k0 + i * 8 + tg * 2 + c < lk;
        s[i][c] = in ? s[i][c] * scale : -INFINITY;
        s[i][c + 2] = in ? s[i][c + 2] * scale : -INFINITY;
      }
    }
    mul = 1.f;
  }
  float t0 = row_max(s, 0) * mul, t1 = row_max(s, 2) * mul;  // mul > 0
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float mn0 = fmaxf(m_r[0], t0), mn1 = fmaxf(m_r[1], t1);
  const float mu0 = (mn0 == -INFINITY) ? 0.f : mn0;
  const float mu1 = (mn1 == -INFINITY) ? 0.f : mn1;
  alpha[0] = fast_exp2(m_r[0] - mu0);
  alpha[1] = fast_exp2(m_r[1] - mu1);
  m_r[0] = mn0;
  m_r[1] = mn1;
  float r0[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    s[i][0] = fast_exp2(fmaf(s[i][0], mul, -mu0));
    s[i][1] = fast_exp2(fmaf(s[i][1], mul, -mu0));
    s[i][2] = fast_exp2(fmaf(s[i][2], mul, -mu1));
    s[i][3] = fast_exp2(fmaf(s[i][3], mul, -mu1));
    r0[i & 3] += s[i][0] + s[i][1];
    r1[i & 3] += s[i][2] + s[i][3];
  }
  l_r[0] = l_r[0] * alpha[0] + ((r0[0] + r0[1]) + (r0[2] + r0[3]));
  l_r[1] = l_r[1] * alpha[1] + ((r1[0] + r1[1]) + (r1[2] + r1[3]));
}

}  // namespace
