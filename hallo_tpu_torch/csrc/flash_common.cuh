// Device code shared by the flash-attention kernels for Hopper (sm_90a):
// flash_fwd.cu (bf16 QK^T; K3) and flash_int8.cu (int8 QK^T; K6);
// flash_fwd_sm90.cu (K1), flash_fwd_d512_sm90.cu (K4) and flash_bwd_sm90.cu
// (K5) take fast_exp2, pack_bf16 and the store; K1 and K4 also the tile
// softmax of the wgmma accumulator layout (`tile_softmax`).
//
// All keep one warp per 16 rows in the mma.sync fragment layout: lane
// (g = lane / 4, tg = lane % 4) holds rows g and g + 8 of each 8-column
// score tile, at columns 2 tg and 2 tg + 1 (e = 0, 1 for row g; e = 2, 3 for
// row g + 8). In the forwards the rows are queries and what follows the
// scores is the same in both: the online base-2 softmax in fp32, P and V as
// bf16 into mma.sync with fp32 accumulation, and the normalised store in the
// output's type (bf16 or fp32).

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory, transposed (the PV B operand);
// lane i gives the address of one 16-byte row (lanes 8m..8m+7 the rows of
// matrix m).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of one
// 16-byte row (lanes 8m..8m+7 the rows of matrix m). Lane t receives row
// t/4, columns 2(t%4) and 2(t%4)+1 of each matrix -- the mma A/B fragment
// layout (ldmatrix_x4_trans gives the transposed matrices).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// rows x DP tile, row-major in shared memory with row stride DP + 8 (the +8
// puts the 8 rows an ldmatrix phase reads on distinct banks). Columns >= D
// and rows >= n_valid are zero-filled.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long s_l, int row0, int n_valid,
                                                int D, int tid, int nthr) {
  constexpr int SROW = DP + 8;
  constexpr int VPR = DP / 8;
  for (int i = tid; i < ROWS * VPR; i += nthr) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int gr = row0 + r;
    const bool valid = gr < n_valid && c < D;
    cp_async16(dst + r * SROW + c, valid ? src + (long long)gr * s_l + c : src, valid);
  }
}

// ROWS rows of a (L, D) matrix of T (row stride s_l elements) into shared
// memory as bf16 (row stride DP + 8: the 8 rows an ldmatrix phase reads on
// distinct banks), 8 columns per thread and step, synchronously; rows >=
// n_valid and columns >= D are zero. fp32 is rounded to bf16 on the way.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows_sync(bf16* dst, const T* src, long long s_l,
                                               int row0, int n_valid, int D, int tid,
                                               int nthr) {
  constexpr int SROW = DP + 8;
  constexpr int VPR = DP / 8;
  for (int i = tid; i < ROWS * VPR; i += nthr) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int gr = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_valid && c < D) {
      const T* s = src + (long long)gr * s_l + c;
      if constexpr (sizeof(T) == 4) {
        const float4 a = reinterpret_cast<const float4*>(s)[0];
        const float4 b = reinterpret_cast<const float4*>(s)[1];
        x = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                       pack_bf16(b.z, b.w));
      } else {
        x = *reinterpret_cast<const uint4*>(s);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * SROW + c) = x;
  }
}

// One key tile's online-softmax step for a warp's rows g and g + 8. `s`
// holds the tile's scores in log2 units (-inf where masked) and receives the
// unnormalised probabilities; `acc` is rescaled to the new running max, and
// `l` is kept quad-partial (reduced in `store_rows`).
template <int KT, int DTILES>
__device__ __forceinline__ void softmax_step(float (&s)[KT][4], float (&acc)[DTILES][4],
                                             float (&m_r)[2], float (&l_r)[2]) {
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
    t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float mn0 = fmaxf(m_r[0], t0), mn1 = fmaxf(m_r[1], t1);
  const float mu0 = (mn0 == -INFINITY) ? 0.f : mn0;
  const float mu1 = (mn1 == -INFINITY) ? 0.f : mn1;
  const float al0 = fast_exp2(m_r[0] - mu0), al1 = fast_exp2(m_r[1] - mu1);
  m_r[0] = mn0;
  m_r[1] = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    s[nt][0] = fast_exp2(s[nt][0] - mu0);
    s[nt][1] = fast_exp2(s[nt][1] - mu0);
    s[nt][2] = fast_exp2(s[nt][2] - mu1);
    s[nt][3] = fast_exp2(s[nt][3] - mu1);
    rs0 += s[nt][0] + s[nt][1];
    rs1 += s[nt][2] + s[nt][3];
  }
  l_r[0] = l_r[0] * al0 + rs0;
  l_r[1] = l_r[1] * al1 + rs1;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    acc[dt][0] *= al0; acc[dt][1] *= al0;
    acc[dt][2] *= al1; acc[dt][3] *= al1;
  }
}

// acc += P V for one key tile: the score accumulator layout of two 8-key
// tiles is the bf16 A operand layout of one 16-key step. V's rows are in
// shared memory with row stride SROW; (v_row, v_col) is this lane's
// ldmatrix address of keys (0-7 | 8-15) x two 8-column tiles.
template <int KT, int DTILES, int SROW>
__device__ __forceinline__ void pv_step(const float (&s)[KT][4], float (&acc)[DTILES][4],
                                        const bf16* Vt, int v_row, int v_col) {
#pragma unroll
  for (int t = 0; t < KT / 2; ++t) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
    a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
    a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
    a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DTILES; dt += 2) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, Vt + (t * 16 + v_row) * SROW + v_col + dt * 8);
      mma_bf16(acc[dt], a, bb[0], bb[1]);
      mma_bf16(acc[dt + 1], a, bb[2], bb[3]);
    }
  }
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
