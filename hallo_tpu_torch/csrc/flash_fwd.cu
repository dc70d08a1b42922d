// Flash-attention forward for Hopper (sm_90a): bf16 or fp32 in and out,
// bf16 tensor-core products, fp32 softmax and accumulation.
//
// Replaces K3, hallo_tpu/ops/pallas_flash.py:120 _attention_kernel_t,
// reached through `flash_attention` (heads-major (B, H, L, D)) when d % 128
// != 0: the wav2vec2 self-attention, 12 heads of d = 64, fp32 I/O. K1
// (natural (B, L, C)) and K4 (d % 128 == 0) have Hopper kernels of their
// own, flash_fwd_sm90.cu and flash_fwd_d512_sm90.cu. This one reads
// q/k/v/o through (batch, token, head) strides with the head dim
// contiguous, so (B, H, L, D) is a (B, L, H, D) view with other strides.
// K3's transposed scores and PV accumulator were a TPU MXU layout choice (d
// on the M axis) and are not carried over.
//
// fp32 I/O (K3): the tiles are read from fp32 and rounded to bf16 on their
// way into shared memory -- the rounding the TPU's MXU applies to fp32 at
// default precision -- so the products are the same bf16 mma.sync; m, l and
// the accumulator are fp32 as always, and the output is written in fp32.
// These loads are synchronous (no cp.async: the type changes on the way).
//
// What bounds it on this card: attention is compute bound at long
// sequences (the audio path's Lq = Lk up to 1056 at d 64), so the products
// run on the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> fp32), and neither the scores nor the
// probabilities ever reach device memory: the online softmax keeps m, l and
// the output accumulator in fp32 registers (log2 domain, scale * log2(e)
// applied to the fp32 scores). A warp owns 16 query rows; the scores'
// accumulator fragment is re-packed in registers as the A operand of the PV
// product. Head dims that are not a multiple of 16 (d = 40) are zero-padded
// in shared memory to the instantiation's width.
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
// TMA or wgmma yet. The softmax step, the PV product and the store are
// flash_common.cuh's, shared with flash_int8.cu.

#include "flash_common.cuh"

namespace {

struct FlashParams {
  const void* q;  // bf16 or fp32, as the instantiation's T
  const void* k;
  const void* v;
  const float* bias;  // (B, Lk) fp32 or nullptr
  void* o;
  int B, H, Lq, Lk, D;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
};

// T: the I/O type (bf16 or float); DP: padded head dim; BK: keys per tile;
// WR: warps, each owning 16 query rows.
template <typename T, int DP, int BK, int WR>
__global__ void __launch_bounds__(32 * WR)
    flash_fwd_kernel(const FlashParams p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BQ = 16 * WR;
  constexpr int NT = 32 * WR;
  constexpr int SROW = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int KT = BK / 8;
  static_assert(DP % 16 == 0, "the padded head dim must be a multiple of 16");
  static_assert(BK % 16 == 0, "key tile must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * SROW;       // 2 buffers of BK x SROW
  bf16* Vs = Ks + 2 * BK * SROW;   // 2 buffers of BK x SROW

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* biasb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  if constexpr (F32) {
    load_rows_sync<T, DP, BQ>(Qs, qb, p.q_sl, q0, p.Lq, p.D, tid, NT);
  } else {
    // Q tile and the first K/V tile in one cp.async group.
    load_rows_async<DP, BQ>(Qs, qb, p.q_sl, q0, p.Lq, p.D, tid, NT);
    load_rows_async<DP, BK>(Ks, kb, p.k_sl, 0, p.Lk, p.D, tid, NT);
    load_rows_async<DP, BK>(Vs, vb, p.v_sl, 0, p.Lk, p.D, tid, NT);
    cp_async_commit();
  }

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  // Per-lane ldmatrix row addresses (see ldmatrix_x4):
  // Q, the A operand: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15).
  const bf16* qfrag = Qs + (wr * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW +
                      (lane >> 4) * 8;
  // K, the B operand of S: keys n0..n0+15 (two n-tiles) x (k 0-7 | 8-15).
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  // V, the B operand of PV, transposed: keys (0-7 | 8-15) x two d-tiles.
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  const int nkv = (p.Lk + BK - 1) / BK;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    bf16* Kc = Ks + (j & 1) * BK * SROW;
    bf16* Vc = Vs + (j & 1) * BK * SROW;
    if constexpr (F32) {
      // this buffer's last readers (tile j - 2) passed the barrier that
      // ends every tile
      load_rows_sync<T, DP, BK>(Kc, kb, p.k_sl, k0, p.Lk, p.D, tid, NT);
      load_rows_sync<T, DP, BK>(Vc, vb, p.v_sl, k0, p.Lk, p.D, tid, NT);
    } else if (j + 1 < nkv) {  // prefetch the next tile into the other buffer
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

    // ---- S = Q K^T ----
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
        mma_bf16(s[nt], a, bb[0], bb[1]);
        mma_bf16(s[nt + 1], a, bb[2], bb[3]);
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

    softmax_step(s, acc, m_r, l_r);
    pv_step<KT, DTILES, SROW>(s, acc, Vc, v_row, v_col);
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  store_rows<T, DTILES>(ob, p.o_sl, acc, l_r, q0 + wr * 16 + g, p.Lq, 0, p.D, tg);
}

template <typename T, int DP, int BK, int WR>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int BQ = 16 * WR;
  constexpr int NT = 32 * WR;
  const size_t smem = (size_t)(BQ + 4 * BK) * (DP + 8) * sizeof(bf16);
  auto kern = flash_fwd_kernel<T, DP, BK, WR>;
  // the shared-memory limit, once per device (one bit each) and instantiation
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(configured & (1ull << (dev & 63)))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured |= 1ull << (dev & 63);
  }
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashParams& p, cudaStream_t st) {
  if (p.D <= 48) return launch<T, 48, 64, 4>(p, st);
  if (p.D <= 64) return launch<T, 64, 64, 4>(p, st);
  if (p.D <= 80) return launch<T, 80, 64, 4>(p, st);
  if (p.D <= 128) return launch<T, 128, 64, 4>(p, st);
  if (p.D <= 160) return launch<T, 160, 64, 4>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Head dims the card takes: any multiple of 8 up to 160.
// dtype: 0 = bf16 q/k/v/o, 1 = fp32 q/k/v/o.
extern "C" int hallo_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    long long bias_sb, float scale_log2, int dtype, void* stream) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<bf16>(p, st);
  if (dtype == 1) return (int)dispatch<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
