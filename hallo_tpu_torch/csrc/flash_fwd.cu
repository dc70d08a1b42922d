// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, fp32 softmax.
//
// Replaces two TPU kernels of hallo_tpu/ops/pallas_flash.py:
//   K1 _attention_kernel_packed (natural (B, L, C = H*D) I/O, all heads), and
//   K4 _attention_kernel (heads-major (B, H, L, D); the VAE mid-block, d = 512).
// Both are one kernel here: it reads q/k/v/o through (batch, token, head)
// strides with the head dim contiguous, so (B, L, C) is the (B, L, H, D) view
// and (B, H, L, D) is the same view with other strides.
//
// What bounds it on this card: the main-path shapes (Lq 256..4096, Lk up to
// 8192, d 40/80/160) are compute bound -- some 10 TFLOP of QK^T and PV per
// denoiser forward at 512^2 -- so the products run on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> fp32), and neither the scores nor the
// probabilities ever reach device memory: the online softmax keeps m, l and
// the output accumulator in fp32 registers (log2 domain, scale * log2(e)
// applied to the fp32 scores). A warp owns 16 query rows; the scores'
// accumulator fragment is re-packed in registers as the A operand of the PV
// product. Head dims that are not a multiple of 16 (d = 40) are zero-padded
// in shared memory to the instantiation's width. d = 512 does not fit one
// warp's registers, so four warps share 16 rows: each contracts a quarter of
// d for the scores (summed through shared memory) and owns a quarter of the
// output columns; its K/V tiles are 32 keys (179 KB of shared memory with
// the double buffers).
//
// Masking: keys past Lk (ragged tiles, Lk as small as 1) score -inf; an
// optional fp32 per-key bias (B, Lk) in natural-log units is added (times
// log2 e). A row whose keys are all -inf gets 0, not NaN. Query rows past Lq
// are computed on zeros and not stored. No padding copies are made.
//
// Data movement: K/V tiles are double-buffered in shared memory and filled
// with cp.async (16 bytes, zero-filling out-of-range rows and padded
// columns), so the next tile's loads overlap this tile's products; all mma
// fragments come from shared memory through ldmatrix (.trans for V). No
// TMA or wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (B, Lk) fp32 or nullptr
  bf16* o;
  int B, H, Lq, Lk, D;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
};

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
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// 16-byte row (lanes 8m..8m+7 the rows of matrix m). Without .trans, lane t
// receives row t/4, columns 2(t%4) and 2(t%4)+1 of each matrix -- the mma
// A/B fragment layout; with .trans, the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// DP: padded head dim; BK: keys per tile; WR: 16-row groups per block;
// WD: warps sharing one row group (splitting d).
template <int DP, int BK, int WR, int WD>
__global__ void __launch_bounds__(32 * WR * WD)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int BQ = 16 * WR;
  constexpr int NT = 32 * WR * WD;
  constexpr int SROW = DP + 8;
  constexpr int DS = DP / WD;  // contraction slice and output slice per warp
  constexpr int KSTEPS = DS / 16;
  constexpr int DTILES = DS / 8;
  constexpr int KT = BK / 8;
  static_assert(DS % 16 == 0, "per-warp d slice must be a multiple of 16");
  static_assert(BK % 16 == 0, "key tile must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * SROW;       // 2 buffers of BK x SROW
  bf16* Vs = Ks + 2 * BK * SROW;   // 2 buffers of BK x SROW
  float4* Sx = reinterpret_cast<float4*>(Vs + 2 * BK * SROW);  // WD > 1 only

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp / WD, wd = warp % WD;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* biasb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  // Q tile and the first K/V tile in one cp.async group.
  load_rows_async<DP, BQ>(Qs, qb, p.q_sl, q0, p.Lq, p.D, tid, NT);
  load_rows_async<DP, BK>(Ks, kb, p.k_sl, 0, p.Lk, p.D, tid, NT);
  load_rows_async<DP, BK>(Vs, vb, p.v_sl, 0, p.Lk, p.D, tid, NT);
  cp_async_commit();

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  // Per-lane ldmatrix row addresses (see ldmatrix_x4):
  // Q, the A operand: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15).
  const bf16* qfrag = Qs + (wr * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW +
                      wd * DS + (lane >> 4) * 8;
  // K, the B operand of S: keys n0..n0+15 (two n-tiles) x (k 0-7 | 8-15).
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = wd * DS + ((lane >> 3) & 1) * 8;
  // V, the B operand of PV, transposed: keys (0-7 | 8-15) x two d-tiles.
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = wd * DS + (lane >> 4) * 8;

  const int nkv = (p.Lk + BK - 1) / BK;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    const bf16* Kc = Ks + (j & 1) * BK * SROW;
    const bf16* Vc = Vs + (j & 1) * BK * SROW;
    if (j + 1 < nkv) {  // prefetch the next tile into the other buffer
      load_rows_async<DP, BK>(Ks + ((j + 1) & 1) * BK * SROW, kb, p.k_sl, k0 + BK,
                              p.Lk, p.D, tid, NT);
      load_rows_async<DP, BK>(Vs + ((j + 1) & 1) * BK * SROW, vb, p.v_sl, k0 + BK,
                              p.Lk, p.D, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q) visible to every warp

    // ---- S = Q K^T over this warp's d slice ----
    float s[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qfrag + ks * 16);
#pragma unroll
      for (int nt = 0; nt < KT; nt += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Kc + (nt * 8 + k_row) * SROW + k_col + ks * 16);
        mma16816(s[nt], a, bb[0], bb[1]);
        mma16816(s[nt + 1], a, bb[2], bb[3]);
      }
    }
    if (WD > 1) {
      // sum the WD partial score tiles of this row group
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
        Sx[((wr * WD + wd) * KT + nt) * 32 + lane] =
            make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w2 = 0; w2 < WD; ++w2) {
          const float4 u = Sx[((wr * WD + w2) * KT + nt) * 32 + lane];
          t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
        }
        s[nt][0] = t.x; s[nt][1] = t.y; s[nt][2] = t.z; s[nt][3] = t.w;
      }
    }

    // ---- scale, bias, bounds (log2 domain) ----
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tg * 2 + (e & 1);
        float x = s[nt][e] * p.scale_log2;
        if (key >= p.Lk) x = -INFINITY;
        else if (biasb) x += biasb[key] * kLog2e;
        s[nt][e] = x;
      }
    }

    // ---- online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3) ----
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
    l_r[0] = l_r[0] * al0 + rs0;  // quad-partial; reduced at the end
    l_r[1] = l_r[1] * al1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= al0; acc[dt][1] *= al0;
      acc[dt][2] *= al1; acc[dt][3] *= al1;
    }

    // ---- O += P V: the S accumulator layout of two key tiles is the A
    // operand layout of one 16-key step ----
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
        ldmatrix_x4_trans(bb, Vc + (t * 16 + v_row) * SROW + v_col + dt * 8);
        mma16816(acc[dt], a, bb[0], bb[1]);
        mma16816(acc[dt + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  // ---- normalise and store ----
  float l0 = l_r[0], l1 = l_r[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = q0 + wr * 16 + g, row1 = row0 + 8;
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int col = wd * DS + dt * 8 + tg * 2;
    if (col < p.D) {
      if (row0 < p.Lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * p.o_sl + col) =
            pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
      if (row1 < p.Lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * p.o_sl + col) =
            pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int DP, int BK, int WR, int WD>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int BQ = 16 * WR;
  constexpr int NT = 32 * WR * WD;
  const size_t smem = (size_t)(BQ + 4 * BK) * (DP + 8) * sizeof(bf16) +
                      (WD > 1 ? (size_t)WR * WD * (BK / 8) * 32 * sizeof(float4) : 0);
  auto kern = flash_fwd_kernel<DP, BK, WR, WD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Head dims the card takes: any multiple of 8 up to 160, and 512.
extern "C" int hallo_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    long long bias_sb, float scale_log2, void* stream) {
  FlashParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = static_cast<const float*>(bias);
  p.o = static_cast<bf16*>(o);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  if (D <= 48) return (int)launch<48, 64, 4, 1>(p, st);
  if (D <= 64) return (int)launch<64, 64, 4, 1>(p, st);
  if (D <= 80) return (int)launch<80, 64, 4, 1>(p, st);
  if (D <= 128) return (int)launch<128, 64, 4, 1>(p, st);
  if (D <= 160) return (int)launch<160, 64, 4, 1>(p, st);
  if (D == 512) return (int)launch<512, 32, 2, 4>(p, st);
  return (int)cudaErrorInvalidValue;
}
