// Flash-attention forward with int8 QK^T scores for Hopper (sm_90a).
//
// Replaces hallo_tpu/ops/pallas_flash.py::_attention_kernel_t_q8 (K6): the
// opt-in (HALLO_INT8_ATTN=1) heads-major attention for long key sides, d % 128
// != 0 -- on the main path the wav2vec2 self-attention at 1024 frames and
// more (12 heads, d = 64, fp32 V). The quantisation prelude stays outside
// the kernel, as XLA did it outside the Pallas call (ops/flash.py
// `quantize_int8`): K mean-smoothed over the keys, per-row absmax scales,
// round half to even, clip to +-127, scale * log2(e) folded into the Q
// scales. This kernel does the rest:
//   S = (q8 k8^T) in int32 on the tensor cores (mma.sync m16n8k32 s8*s8->s32),
//   dequantised as S * ks[key] * qs[row], plus the per-key bias * log2(e);
//   online base-2 softmax in fp32; P and V rounded to bf16 into mma.sync
//   m16n8k16 with fp32 accumulation; the output in V's type (bf16 or fp32).
// Scores and probabilities never reach device memory. Everything after the
// scores (softmax, PV, store) is flash_common.cuh's, shared with flash_fwd.cu.
//
// What bounds it on this card: at the audio path's shapes (Lq = Lk = 1056,
// 12 heads of d = 64) the work is small either way -- 1.7 G int8 ops for
// QK^T and 1.7 GFLOP bf16 for PV, 0.9 + 1.7 us at the peaks, against 3 MB of
// int8 q/k and 3.2 MB each of fp32 V and O (2.8 us at 3.35 TB/s) -- so
// launch latency and the 204 blocks' single wave set its time. The kernel is
// written to be right and simple: one 64-query block per (head, batch), one
// warp per 16 rows, 64-key tiles loaded synchronously into shared memory
// (int8 q/k rows padded by 16 bytes, bf16 V rows by 16 bytes, so that the
// fragment reads of a warp hit distinct banks).
//
// Masking: keys past Lk are masked by bounds (score -inf, in place of the
// JAX kernel's MASK_VALUE padding; the result is the same); the head dim is
// zero-padded in shared memory to the instantiation's multiple of 32 (the
// mma k-depth), which d = 64 does not need. A row whose keys are all -inf
// gets 0, not NaN.

#include "flash_common.cuh"

namespace {

constexpr int kBK = 64;  // keys per tile
constexpr int kWR = 4;   // warps (16 query rows each) per block

struct Int8Params {
  const int8_t* q8;    // (B, H, Lq, D) contiguous
  const int8_t* k8;    // (B, H, Lk, D) contiguous
  const void* v;       // (B, H, Lk, D) through strides, bf16 or fp32
  const float* bias;   // (B, Lk) natural-log units, or nullptr
  const float* qs;     // (B, H, Lq) contiguous, times scale * log2(e)
  const float* ks;     // (B, H, Lk) contiguous
  void* o;             // (B, H, Lq, D) contiguous, V's type
  int B, H, Lq, Lk, D;
  long long v_sb, v_sh, v_sl;
  long long bias_sb;
};

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col)
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS int8 rows of a contiguous (L, D) matrix into shared memory (row
// stride SROW bytes), 8 bytes per thread and step; rows >= n_valid and
// columns >= D are zero.
template <int DP, int ROWS>
__device__ __forceinline__ void load_i8_rows(int8_t* dst, const int8_t* src, int row0,
                                             int n_valid, int D, int tid, int nthr) {
  constexpr int SROW = DP + 16;
  constexpr int VPR = DP / 8;
  for (int i = tid; i < ROWS * VPR; i += nthr) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int gr = row0 + r;
    uint2 x = make_uint2(0u, 0u);
    if (gr < n_valid && c < D)
      x = *reinterpret_cast<const uint2*>(src + (long long)gr * D + c);
    *reinterpret_cast<uint2*>(dst + r * SROW + c) = x;
  }
}

// T: V's and O's type; DP: the head dim padded to a multiple of 32.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kWR) flash_int8_kernel(const Int8Params p) {
  constexpr int BQ = 16 * kWR;
  constexpr int NT = 32 * kWR;
  constexpr int SQ = DP + 16;  // int8 row stride (bytes)
  constexpr int SV = DP + 8;   // bf16 row stride (elements)
  constexpr int KSTEPS = DP / 32;
  constexpr int DTILES = DP / 8;
  constexpr int KT = kBK / 8;
  static_assert(DP % 32 == 0 && DTILES % 2 == 0, "head dim tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Ks = Qs + BQ * SQ;
  bf16* Vs = reinterpret_cast<bf16*>(Ks + kBK * SQ);
  float* ks_s = reinterpret_cast<float*>(Vs + kBK * SV);
  float* bias_s = ks_s + kBK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)b * p.H + h;

  const int8_t* qb = p.q8 + bh * p.Lq * p.D;
  const int8_t* kb = p.k8 + bh * p.Lk * p.D;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ksb = p.ks + bh * p.Lk;
  const float* biasb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_i8_rows<DP, BQ>(Qs, qb, q0, p.Lq, p.D, tid, NT);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float qs0 = row0 < p.Lq ? p.qs[bh * p.Lq + row0] : 0.f;
  const float qs1 = row1 < p.Lq ? p.qs[bh * p.Lq + row1] : 0.f;

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  const int8_t* qrow0 = Qs + (warp * 16 + g) * SQ + tg * 4;
  const int8_t* qrow1 = qrow0 + 8 * SQ;
  // V, the B operand of PV, transposed: keys (0-7 | 8-15) x two d-tiles.
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  const int nkv = (p.Lk + kBK - 1) / kBK;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // every warp is done with the previous tile
    load_i8_rows<DP, kBK>(Ks, kb, k0, p.Lk, p.D, tid, NT);
    load_rows_sync<T, DP, kBK>(Vs, vb, p.v_sl, k0, p.Lk, p.D, tid, NT);
    for (int r = tid; r < kBK; r += NT) {
      const int key = k0 + r;
      const bool in = key < p.Lk;
      ks_s[r] = in ? ksb[key] : 0.f;
      bias_s[r] = !in ? -INFINITY : (biasb ? biasb[key] * kLog2e : 0.f);
    }
    __syncthreads();  // tile j (and Q) visible to every warp

    // ---- S = q8 k8^T in int32 ----
    int si[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qrow0 + kk * 32);
      a[1] = *reinterpret_cast<const uint32_t*>(qrow1 + kk * 32);
      a[2] = *reinterpret_cast<const uint32_t*>(qrow0 + kk * 32 + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(qrow1 + kk * 32 + 16);
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        const int8_t* krow = Ks + (nt * 8 + g) * SQ + kk * 32 + tg * 4;
        mma_s8(si[nt], a, *reinterpret_cast<const uint32_t*>(krow),
               *reinterpret_cast<const uint32_t*>(krow + 16));
      }
    }

    // ---- dequantise, bias, bounds (log2 domain) ----
    float s[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = (float)si[nt][e] * ks_s[kc] * (e < 2 ? qs0 : qs1) + bias_s[kc];
      }
    }

    softmax_step(s, acc, m_r, l_r);
    pv_step<KT, DTILES, SV>(s, acc, Vs, v_row, v_col);
  }

  T* ob = static_cast<T*>(p.o) + bh * p.Lq * p.D;
  store_rows<T, DTILES>(ob, p.D, acc, l_r, row0, p.Lq, 0, p.D, tg);
}

template <typename T, int DP>
cudaError_t launch(const Int8Params& p, cudaStream_t stream) {
  constexpr int BQ = 16 * kWR;
  const size_t smem = (size_t)(BQ + kBK) * (DP + 16) + (size_t)kBK * (DP + 8) * sizeof(bf16) +
                      2 * kBK * sizeof(float);
  auto kern = flash_int8_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, 32 * kWR, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Int8Params& p, cudaStream_t st) {
  if (p.D <= 64) return launch<T, 64>(p, st);
  if (p.D <= 128) return launch<T, 128>(p, st);
  if (p.D <= 160) return launch<T, 160>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Head dims: any multiple of 8 up to 160. dtype: 0 = bf16 V and O, 1 = fp32.
extern "C" int hallo_flash_int8(const void* q8, const void* k8, const void* v,
                                const void* bias, const void* qs, const void* ks, void* o,
                                int B, int H, int Lq, int Lk, int D, int dtype,
                                long long v_sb, long long v_sh, long long v_sl,
                                long long bias_sb, void* stream) {
  if (D <= 0 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  Int8Params p;
  p.q8 = static_cast<const int8_t*>(q8);
  p.k8 = static_cast<const int8_t*>(k8);
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.qs = static_cast<const float*>(qs);
  p.ks = static_cast<const float*>(ks);
  p.o = o;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.bias_sb = bias_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<bf16>(p, st);
  if (dtype == 1) return (int)dispatch<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
