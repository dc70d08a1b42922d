// Frame-axis (temporal) self-attention for Hopper (sm_90a), bf16 in / out.
//
// Replaces hallo_tpu/ops/pallas_temporal.py::_temporal_kernel (K2), and takes
// the natural (B, F, L, C = H*D) layout of _temporal_kernel_packed (K7): at
// every spatial site l and head h, softmax(q k^T * scale) v over the F frames
// (16 clip + 2 motion frames on the main path).
//
// What bounds it on this card: memory, once the arithmetic keeps up. Each
// call reads q, k and v once and writes o once (about 94 MB each at level 0
// of the 512^2 denoiser: 0.11 ms at 3.35 TB/s), while the math is an F x F x d
// problem per site and head -- far too small for the tensor cores. So a block
// takes one (batch, site tile, head), loads the tile's q, k and v for all
// frames into shared memory with 16-byte reads of the head's contiguous d
// channels, and one thread per (site, query frame) computes its F scores,
// the fp32 exp2 softmax and its output row from shared memory. Scores and
// probabilities stay in registers; nothing but o is written. The output is
// staged in place of the thread's own q row and then stored with 16-byte
// writes. The head is the fastest grid axis, so the blocks of all heads of
// one site tile run together and share the L2 lines of the (frame, site)
// rows they each read a d-wide slice of.
//
// Measured on the card, the per-thread FMA chains, not the traffic, set the
// time of a first version (1.6 ms of compute against 0.15 ms of loads and
// stores at level 0). Two things fix most of that: the output accumulates 8
// channels at once (8 independent FMA chains instead of 2), and the frame
// count is a template parameter for the main path's 16 and 18 frames, so
// the frame loops unroll without guards.
//
// Shared-memory rows are site-major ([site][frame][d]) with a stride of
// d + 2 elements: an odd number of 32-bit words, so the 32 threads of a warp,
// which read 32 consecutive rows, hit 32 distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kFMax = 32;  // frames (clip + motion) <= temporal PE max_len

struct TemporalParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, F, L, H, D;
  int T;  // sites per block
  long long s_b, s_f, s_l;  // element strides; channels contiguous
  float scale_log2;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_row8(bf16* dst, uint4 v) {
  // dst is 4-byte aligned only (row stride d + 2)
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
  d32[0] = v.x; d32[1] = v.y; d32[2] = v.z; d32[3] = v.w;
}

__device__ __forceinline__ uint4 load_row8(const bf16* src) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
  return make_uint4(s32[0], s32[1], s32[2], s32[3]);
}

// FT > 0: the frame count is the compile-time FT (16 and 18 on the main
// path: the clip alone, or with the 2 motion frames), so the frame loops
// unroll without guards; FT = 0 takes any F <= kFMax at run time.
template <int FT>
__global__ void temporal_attn_kernel(const TemporalParams p) {
  constexpr int FMAX = FT > 0 ? FT : kFMax;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = FT > 0 ? FT : p.F;
  const int T = p.T, D = p.D;
  const int RS = D + 2;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + T * F * RS;
  bf16* vs = ks + T * F * RS;

  const int b = blockIdx.z, h = blockIdx.x;
  const int l0 = blockIdx.y * T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int vpr = D / 8;
  const long long base = (long long)b * p.s_b + (long long)h * D;

  // ---- cooperative load of the tile (rows = (site, frame)), four 16-byte
  // vectors of each of q, k, v in flight per thread ----
  const int nvec = T * F * vpr;
  constexpr int kGroup = 4;
  for (int i0 = tid; i0 < nvec; i0 += kGroup * nthr) {
    uint4 buf[3][kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = i0 + u * nthr;
      const int r = i / vpr;  // r = site * F + f
      const int l = l0 + r / F;
      buf[0][u] = buf[1][u] = buf[2][u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec && l < p.L) {
        const long long off = base + (long long)(r % F) * p.s_f +
                              (long long)l * p.s_l + (i % vpr) * 8;
        buf[0][u] = *reinterpret_cast<const uint4*>(p.q + off);
        buf[1][u] = *reinterpret_cast<const uint4*>(p.k + off);
        buf[2][u] = *reinterpret_cast<const uint4*>(p.v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = i0 + u * nthr;
      if (i < nvec) {
        const int at = (i / vpr) * RS + (i % vpr) * 8;
        store_row8(qs + at, buf[0][u]);
        store_row8(ks + at, buf[1][u]);
        store_row8(vs + at, buf[2][u]);
      }
    }
  }
  __syncthreads();

  // ---- one thread per (site, query frame) ----
  const int site = tid / F, f = tid % F;
  if (site < T && l0 + site < p.L) {
    bf16* qrow = qs + (site * F + f) * RS;
    const bf16* kbase = ks + site * F * RS;
    const bf16* vbase = vs + site * F * RS;
    float s[FMAX];
#pragma unroll
    for (int g = 0; g < FMAX; ++g) s[g] = 0.f;
    for (int d = 0; d < D; d += 2) {
      const float2 qf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + d));
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < F) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kbase + g * RS + d));
          s[g] += qf.x * kf.x + qf.y * kf.y;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < FMAX; ++g)
      if (g < F) {
        s[g] *= p.scale_log2;
        mx = fmaxf(mx, s[g]);
      }
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < FMAX; ++g)
      if (g < F) {
        s[g] = fast_exp2(s[g] - mx);
        sum += s[g];
      }
    const float inv = 1.f / sum;
    // Output over the thread's own (already consumed) q row, 8 channels at a
    // time: 8 independent accumulators keep the FMA pipes fed where one
    // accumulator per channel pair would serialise F dependent FMAs.
    for (int d = 0; d < D; d += 8) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < F) {
          const __nv_bfloat162* vrow =
              reinterpret_cast<const __nv_bfloat162*>(vbase + g * RS + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 vf = __bfloat1622float2(vrow[j]);
            acc[2 * j] += s[g] * vf.x;
            acc[2 * j + 1] += s[g] * vf.y;
          }
        }
      }
      __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(qrow + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[j] = __floats2bfloat162_rn(acc[2 * j] * inv, acc[2 * j + 1] * inv);
    }
  }
  __syncthreads();

  // ---- cooperative store ----
  for (int i = tid; i < nvec; i += nthr) {
    const int c = (i % vpr) * 8;
    const int r = i / vpr;
    const int site = r / F, f = r % F;
    const int l = l0 + site;
    if (l < p.L) {
      const long long off = base + (long long)f * p.s_f + (long long)l * p.s_l + c;
      *reinterpret_cast<uint4*>(p.o + off) = load_row8(qs + r * RS + c);
    }
  }
}

}  // namespace

// q, k, v, o: (B, F, L, H*D) bf16 with channels contiguous and the given
// element strides; T sites per block (the caller sizes it to shared memory).
extern "C" int hallo_temporal_attn(const void* q, const void* k, const void* v,
                                   void* o, int B, int F, int L, int H, int D,
                                   int T, long long s_b, long long s_f,
                                   long long s_l, float scale_log2,
                                   void* stream) {
  if (F <= 0 || F > kFMax || D <= 0 || D % 8 != 0 || T <= 0 || L <= 0 ||
      (L + T - 1) / T > 65535)
    return (int)cudaErrorInvalidValue;
  TemporalParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.B = B; p.F = F; p.L = L; p.H = H; p.D = D; p.T = T;
  p.s_b = s_b; p.s_f = s_f; p.s_l = s_l;
  p.scale_log2 = scale_log2;
  const size_t smem = (size_t)3 * T * F * (D + 2) * sizeof(bf16);
  int threads = ((T * F + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  auto kern = F == 16 ? temporal_attn_kernel<16>
              : F == 18 ? temporal_attn_kernel<18> : temporal_attn_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (L + T - 1) / T, B);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
