// Flash-attention backward for Hopper (sm_90a): bf16 or fp32 in and out,
// bf16 tensor-core products, fp32 recomputation and accumulation.
//
// Replaces K5 of hallo_tpu/ops/pallas_flash.py: `_dkv_kernel_packed` (dK and
// dV) and `_dq_kernel_packed` (dQ), driven by `_flash_backward_packed`, the
// backward of K1 (`_attention_kernel_packed`) on natural (B, L, C = H*D)
// tensors. Both passes recompute the probabilities from the forward's saved
// base-2 logsumexp (flash_fwd.cu's `lse`), so no (Lq, Lk) scores tensor
// reaches device memory:
//
//   s  = (q . k) * scale * log2(e) + bias * log2(e)    (the forward's logits)
//   P  = exp2(s - lse)                                  (the softmax, exactly)
//   dV = P^T dO          dP = dO V^T
//   dS = P * (dP - Delta),   Delta = rowsum(dO * O)     (fp32, from the wrapper)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// The JAX kernels fold scale * log2(e) into a bf16 copy of q and give dK the
// factor ln 2 at its store; here the scale is applied to the fp32 scores as
// in the forward, and dQ and dK take `scale` at their stores. The bias gets
// no gradient: every bias of the model is a constant mask, and JAX's
// backward returns a zero cotangent for it (pallas_flash.py:723-739).
//
// The two passes are JAX's, and need no atomics, so the result does not
// depend on the order blocks run in:
// - dK/dV: one block per (batch, head, 64 keys). Each warp owns 16 keys and
//   keeps their dK and dV rows in fp32 registers while the block walks over
//   every query tile; K and V stay in shared memory, Q and dO tiles are
//   double-buffered with cp.async. Four products per tile: S^T = K Q^T,
//   dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. At d > 80 (two 160-wide fp32
//   accumulators per lane would spill) two warps share 16 keys: each
//   computes the full S^T and dP^T and keeps half of the dK/dV columns.
// - dQ: one block per (batch, head, 64 queries). Each warp owns 16 queries
//   and keeps their dQ rows in registers while the block walks over every
//   key tile (double-buffered K and V). Three products per tile: S = Q K^T,
//   dP = dO V^T, dQ += dS K.
//
// What bounds it on this card: like the forward, the products. At the
// training shapes (Lq 256..4096, Lk up to 8192, d 40/80/160) its seven
// products of 2 Lq Lk d operations (four in the dK/dV pass, three in the dQ
// pass) are 3.5x the forward's two; they run on the tensor cores (mma.sync
// m16n8k16 bf16 -> fp32), and P, dP and dS live only in registers: the
// score accumulator fragment is re-packed as the bf16 A operand of the next
// product
// (flash_common.cuh's `pv_step`). d = 40 is zero-padded to 48 in shared
// memory; only the real columns are stored. Keys past Lk score -inf (P = 0),
// query rows past Lq carry lse = +inf (P = 0): no padding copies.
// No TMA or wgmma yet.

#include "flash_common.cuh"

namespace {

struct BwdParams {
  const void* q;     // (B, Lq, C), C = H * D, contiguous; T
  const void* k;     // (B, Lk, C)
  const void* v;     // (B, Lk, C)
  const void* dout;  // (B, Lq, C): the output's gradient
  const float* bias;   // (B, Lk) natural-log units, or nullptr
  const float* lse;    // (B, H, Lq) base-2 logsumexp from the forward
  const float* delta;  // (B, H, Lq) rowsum(dO * O)
  void* dq;  // (B, Lq, C)
  void* dk;  // (B, Lk, C)
  void* dv;  // (B, Lk, C)
  int B, H, Lq, Lk, D;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

// Row tile of a (rows, C) slab (row stride C) into shared memory as bf16:
// cp.async for bf16 (the caller commits), a synchronous converting load for
// fp32.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const T* src, int C, int row0,
                                          int n_valid, int D, int tid, int nthr) {
  if constexpr (sizeof(T) == 4) {
    load_rows_sync<T, DP, ROWS>(dst, src, C, row0, n_valid, D, tid, nthr);
  } else {
    load_rows_async<DP, ROWS>(dst, src, C, row0, n_valid, D, tid, nthr);
  }
}

// acc[KT][4] = A (16 rows x DP, rows at `afrag`) times B^T (KT*8 rows x DP,
// row stride SROW): the scores' product, contracting KSTEPS*16 columns.
// (b_row, b_col) is this lane's ldmatrix address in B (two 8-row tiles x
// (k 0-7 | 8-15)).
template <int KT, int KSTEPS, int SROW>
__device__ __forceinline__ void scores(float (&acc)[KT][4], const bf16* afrag, const bf16* Bt,
                                       int b_row, int b_col) {
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, afrag + ks * 16);
#pragma unroll
    for (int nt = 0; nt < KT; nt += 2) {
      uint32_t bb[4];
      ldmatrix_x4(bb, Bt + (nt * 8 + b_row) * SROW + b_col + ks * 16);
      mma_bf16(acc[nt], a, bb[0], bb[1]);
      mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
    }
  }
}

// dQ pass. DP: padded head dim; BK: keys per tile. 4 warps, 64 queries.
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BQ = 64;
  constexpr int NT = 128;
  constexpr int SROW = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int KT = BK / 8;
  static_assert(DP % 16 == 0 && BK % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x SROW
  bf16* dOs = Qs + BQ * SROW;                      // BQ x SROW
  bf16* Ks = dOs + BQ * SROW;                      // 2 buffers of BK x SROW
  bf16* Vs = Ks + 2 * BK * SROW;                   // 2 buffers of BK x SROW

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int C = p.H * p.D;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.Lq * C + h * p.D;
  const T* dob = static_cast<const T*>(p.dout) + (long long)b * p.Lq * C + h * p.D;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.Lk * C + h * p.D;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.Lk * C + h * p.D;
  const float* biasb = p.bias ? p.bias + (long long)b * p.Lk : nullptr;

  load_tile<T, DP, BQ>(Qs, qb, C, q0, p.Lq, p.D, tid, NT);
  load_tile<T, DP, BQ>(dOs, dob, C, q0, p.Lq, p.D, tid, NT);
  if constexpr (sizeof(T) == 2) {
    load_tile<T, DP, BK>(Ks, kb, C, 0, p.Lk, p.D, tid, NT);
    load_tile<T, DP, BK>(Vs, vb, C, 0, p.Lk, p.D, tid, NT);
    cp_async_commit();
  }

  // This lane's rows g and g + 8: their lse (+inf past Lq: P = 0) and Delta.
  const long long rows = ((long long)b * p.H + h) * p.Lq;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float lse0 = r0 < p.Lq ? p.lse[rows + r0] : INFINITY;
  const float lse1 = r1 < p.Lq ? p.lse[rows + r1] : INFINITY;
  const float dd0 = r0 < p.Lq ? p.delta[rows + r0] : 0.f;
  const float dd1 = r1 < p.Lq ? p.delta[rows + r1] : 0.f;

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix addresses: the A operands (Q, dO rows of this warp); K and V
  // as the B operand of the scores; K transposed as the B operand of dS K.
  const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  const int nkv = (p.Lk + BK - 1) / BK;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    bf16* Kc = Ks + (j & 1) * BK * SROW;
    bf16* Vc = Vs + (j & 1) * BK * SROW;
    if constexpr (sizeof(T) == 4) {
      load_tile<T, DP, BK>(Kc, kb, C, k0, p.Lk, p.D, tid, NT);
      load_tile<T, DP, BK>(Vc, vb, C, k0, p.Lk, p.D, tid, NT);
    } else if (j + 1 < nkv) {
      load_tile<T, DP, BK>(Ks + ((j + 1) & 1) * BK * SROW, kb, C, k0 + BK, p.Lk, p.D, tid, NT);
      load_tile<T, DP, BK>(Vs + ((j + 1) & 1) * BK * SROW, vb, C, k0 + BK, p.Lk, p.D, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q, dO) visible to every warp

    float s[KT][4], dp[KT][4];
    scores<KT, KSTEPS, SROW>(s, Qs + a_off, Kc, b_row, b_col);
    scores<KT, KSTEPS, SROW>(dp, dOs + a_off, Vc, b_row, b_col);
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tg * 2 + (e & 1);
        float x = s[nt][e] * p.scale_log2;
        if (key >= p.Lk) x = -INFINITY;
        else if (biasb) x += biasb[key] * kLog2e;
        const float pr = fast_exp2(x - (e < 2 ? lse0 : lse1));
        s[nt][e] = pr * (dp[nt][e] - (e < 2 ? dd0 : dd1));  // dS
      }
    }
    pv_step<KT, DTILES, SROW>(s, acc, Kc, t_row, t_col);  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  T* dqb = static_cast<T*>(p.dq) + (long long)b * p.Lq * C + h * p.D;
  store_scaled<T, DTILES>(dqb, C, acc, p.scale, p.scale, r0, p.Lq, 0, p.D, tg);
}

// dK/dV pass. DP: padded head dim; BQ: queries per tile; WD: warps sharing
// 16 keys (each keeps DP / WD of the dK/dV columns). 4 x WD warps, 64 keys.
template <typename T, int DP, int BQ, int WD>
__global__ void __launch_bounds__(128 * WD) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BKV = 64;
  constexpr int NT = 128 * WD;
  constexpr int SROW = DP + 8;
  constexpr int KSTEPS = DP / 16;  // the scores contract the full head dim
  constexpr int DS = DP / WD;      // dK/dV columns per warp
  constexpr int DTILES = DS / 8;
  constexpr int QT = BQ / 8;
  static_assert(DP % 16 == 0 && DS % 16 == 0 && BQ % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BKV x SROW
  bf16* Vs = Ks + BKV * SROW;                      // BKV x SROW
  bf16* Qs = Vs + BKV * SROW;                      // 2 buffers of BQ x SROW
  bf16* dOs = Qs + 2 * BQ * SROW;                  // 2 buffers of BQ x SROW
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * SROW);  // 2 x BQ lse
  float* Dl = Ls + 2 * BQ;                                     // 2 x BQ Delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp / WD, wd = warp % WD;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const int C = p.H * p.D;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.Lq * C + h * p.D;
  const T* dob = static_cast<const T*>(p.dout) + (long long)b * p.Lq * C + h * p.D;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.Lk * C + h * p.D;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.Lk * C + h * p.D;
  const float* lseb = p.lse + ((long long)b * p.H + h) * p.Lq;
  const float* ddb = p.delta + ((long long)b * p.H + h) * p.Lq;

  // lse (+inf past Lq: P = 0) and Delta of one query tile into buffer `buf`
  auto load_rows_stats = [&](int buf, int i0) {
    for (int i = tid; i < BQ; i += NT) {
      const bool in = i0 + i < p.Lq;
      Ls[buf * BQ + i] = in ? lseb[i0 + i] : INFINITY;
      Dl[buf * BQ + i] = in ? ddb[i0 + i] : 0.f;
    }
  };

  load_tile<T, DP, BKV>(Ks, kb, C, k0, p.Lk, p.D, tid, NT);
  load_tile<T, DP, BKV>(Vs, vb, C, k0, p.Lk, p.D, tid, NT);
  if constexpr (sizeof(T) == 2) {
    load_tile<T, DP, BQ>(Qs, qb, C, 0, p.Lq, p.D, tid, NT);
    load_tile<T, DP, BQ>(dOs, dob, C, 0, p.Lq, p.D, tid, NT);
    cp_async_commit();
  }
  load_rows_stats(0, 0);

  // This lane's keys (rows g and g + 8 of the warp's 16): their bias in
  // log2 units, -inf past Lk (P = 0).
  const int key0 = k0 + wr * 16 + g, key1 = key0 + 8;
  const float* biasb = p.bias ? p.bias + (long long)b * p.Lk : nullptr;
  const float kb0 = key0 < p.Lk ? (biasb ? biasb[key0] * kLog2e : 0.f) : -INFINITY;
  const float kb1 = key1 < p.Lk ? (biasb ? biasb[key1] * kLog2e : 0.f) : -INFINITY;

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // ldmatrix addresses: K and V rows of this warp's keys as A operands; Q
  // and dO rows as the B operand of the scores; dO and Q transposed as the B
  // operands of P^T dO and dS^T Q (this warp's column slice).
  const int a_off = (wr * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = wd * DS + (lane >> 4) * 8;

  const int nq = (p.Lq + BQ - 1) / BQ;
  for (int j = 0; j < nq; ++j) {
    const int i0 = j * BQ;
    const int buf = j & 1;
    bf16* Qc = Qs + buf * BQ * SROW;
    bf16* dOc = dOs + buf * BQ * SROW;
    if constexpr (sizeof(T) == 4) {
      load_tile<T, DP, BQ>(Qc, qb, C, i0, p.Lq, p.D, tid, NT);
      load_tile<T, DP, BQ>(dOc, dob, C, i0, p.Lq, p.D, tid, NT);
      if (j > 0) load_rows_stats(buf, i0);
    } else if (j + 1 < nq) {
      load_tile<T, DP, BQ>(Qs + (buf ^ 1) * BQ * SROW, qb, C, i0 + BQ, p.Lq, p.D, tid, NT);
      load_tile<T, DP, BQ>(dOs + (buf ^ 1) * BQ * SROW, dob, C, i0 + BQ, p.Lq, p.D, tid, NT);
      cp_async_commit();
      load_rows_stats(buf ^ 1, i0 + BQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and K, V) visible to every warp

    float s[QT][4], dp[QT][4];
    scores<QT, KSTEPS, SROW>(s, Ks + a_off, Qc, b_row, b_col);   // S^T = K Q^T
    scores<QT, KSTEPS, SROW>(dp, Vs + a_off, dOc, b_row, b_col); // dP^T = V dO^T
    const float* lt = Ls + buf * BQ;
    const float* dl = Dl + buf * BQ;
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = fast_exp2(s[nt][e] * p.scale_log2 + (e < 2 ? kb0 : kb1) - lt[i]);  // P^T
      }
    }
    pv_step<QT, DTILES, SROW>(s, dv, dOc, t_row, t_col);  // dV += P^T dO
#pragma unroll
    for (int nt = 0; nt < QT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + tg * 2 + (e & 1);
        s[nt][e] *= dp[nt][e] - dl[i];  // dS^T
      }
    }
    pv_step<QT, DTILES, SROW>(s, dk, Qc, t_row, t_col);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  const long long off = (long long)b * p.Lk * C + h * p.D;
  store_scaled<T, DTILES>(static_cast<T*>(p.dk) + off, C, dk, p.scale, p.scale, key0, p.Lk,
                          wd * DS, p.D, tg);
  store_scaled<T, DTILES>(static_cast<T*>(p.dv) + off, C, dv, 1.f, 1.f, key0, p.Lk,
                          wd * DS, p.D, tg);
}

template <typename T, int DP, int BK>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * 64 + 4 * BK) * (DP + 8) * sizeof(bf16);
  auto kern = flash_bwd_dq_kernel<T, DP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + 63) / 64, p.H, p.B);
  kern<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, int BQ, int WD>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * 64 + 4 * BQ) * (DP + 8) * sizeof(bf16) +
                      (size_t)4 * BQ * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, DP, BQ, WD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + 63) / 64, p.H, p.B);
  kern<<<grid, 128 * WD, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const BwdParams& p, cudaStream_t st) {
  if (p.D <= 48) return launch_dq<T, 48, 64>(p, st);
  if (p.D <= 64) return launch_dq<T, 64, 64>(p, st);
  if (p.D <= 80) return launch_dq<T, 80, 64>(p, st);
  if (p.D <= 128) return launch_dq<T, 128, 64>(p, st);
  if (p.D <= 160) return launch_dq<T, 160, 64>(p, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(const BwdParams& p, cudaStream_t st) {
  if (p.D <= 48) return launch_dkv<T, 48, 64, 1>(p, st);
  if (p.D <= 64) return launch_dkv<T, 64, 64, 1>(p, st);
  if (p.D <= 80) return launch_dkv<T, 80, 64, 1>(p, st);
  if (p.D <= 128) return launch_dkv<T, 128, 64, 2>(p, st);
  if (p.D <= 160) return launch_dkv<T, 160, 64, 2>(p, st);
  return cudaErrorInvalidValue;
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* bias, const void* lse, const void* delta, void* dq,
                      void* dk, void* dv, int B, int H, int Lq, int Lk, int D, float scale,
                      float scale_log2) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  return p;
}

bool valid(int B, int H, int Lq, int Lk, int D) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && D > 0 && D % 8 == 0 && D <= 160;
}

}  // namespace

// q, dout, dq: (B, Lq, H*D); k, v, dk, dv: (B, Lk, H*D), all contiguous, of
// one type (dtype 0 = bf16, 1 = fp32); bias (B, Lk) fp32 or null; lse and
// delta (B, H, Lq) fp32. Head dims: multiples of 8 up to 160.
extern "C" int hallo_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* bias,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Lq, int Lk,
    int D, float scale, float scale_log2, int dtype, void* stream) {
  if (!valid(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const BwdParams p = make_params(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, B, H, Lq,
                                  Lk, D, scale, scale_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dkv<bf16>(p, st);
  if (dtype == 1) return (int)dispatch_dkv<float>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hallo_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* bias,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq, int Lk, int D,
    float scale, float scale_log2, int dtype, void* stream) {
  if (!valid(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const BwdParams p = make_params(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, B, H,
                                  Lq, Lk, D, scale, scale_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dq<bf16>(p, st);
  if (dtype == 1) return (int)dispatch_dq<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
