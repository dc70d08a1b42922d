// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a): 3x3, stride 1, zero
// padding 1, NHWC input, bf16 or fp32 I/O.
//
// Replaces hallo_tpu/ops/pallas_winograd.py::_wino_kernel (K8). Each 2x2
// output tile t (T = N * H/2 * W/2 of them) reads one 4x4 input patch d; then
//   V[k] = (B^T d B)[k]     the input transform, 16 positions k, per channel;
//   M[k] = V[k] @ U[k]      16 products (T x C) @ (C x Co), U = G w G^T;
//   Y    = A^T M A          the output transform, 2x2 pixels per tile;
// plus the bias, in fp32.
//
// What bounds it on this card: the 16 products, 2 * 16 * T * C * Co
// operations on the tensor cores (0.109 ms at the denoiser's level-0 shape,
// (32, 64, 64, 320) -> 320, against 0.051 ms for the bytes of x, U and y;
// reckoned from the shapes). V and M are 16x the size of x and y (335 MB
// and 671 MB at that shape), so neither goes to device memory: one block
// owns 32 tiles x 64 output channels and keeps M for all 16 positions in
// its 8 warps' registers (128 fp32 accumulators per lane) while it walks C
// in steps of 16. Per step, the tiles' 4x4 input patches (zero outside the
// image: the padding is a mask, not a copy) and the U slice go into shared
// memory as cp.async copies, one step ahead of their use (two buffers); the
// block forms the V slice there, then runs the 16 products with mma.sync
// (bf16 in, fp32 accumulators). A warp owns 4 positions x 32 tiles x 32
// channels, so each operand fragment it loads feeds two products. At the
// end M goes through shared memory once, and one thread per (tile, channel
// pair) does the output transform and the bias, a warp storing 64 channels
// of a tile's 4 pixels. The blocks of one tile range (every 64 output
// channels of it) are neighbours in launch order, so they share the L2
// lines of the patches they read.
//
// What this simple design leaves (timed on the card with one part of the
// step switched off at a time, in throwaway variants): the step's patch
// copies, U copies, input transform and products each take a similar share
// of the time and do not overlap; the copies are bound by
// L2 traffic, because each block reads all of U's 64 columns for only 32
// tiles and each of the Co / 64 blocks of a tile range reads the tiles'
// patches again (about 5 GB at level 0, reckoned). Sharing U across a
// cluster (TMA multicast), deduplicating the overlapping patches, warp
// specialisation and wgmma are left for later. fp32 I/O rounds V and U to
// bf16 for the tensor cores (the TPU MXU's default precision, as the fp32
// flash kernel does).

#include "flash_common.cuh"

#include <limits.h>

namespace {

constexpr int kTM = 32;               // tiles per block
constexpr int kTN = 64;               // output channels per block
constexpr int kCK = 16;               // input channels per step
constexpr int kThreads = 256;         // 8 warps: 4 position groups x 2 channel halves
constexpr int kPG = 4;                // positions per warp
constexpr int kGroups = 16 / kPG;     // warps along the positions
static_assert(kTM == 32 && kGroups * (kTN / 32) == kThreads / 32,
              "a warp owns all 32 tiles x 32 channels at its 4 positions");
constexpr int kVS = kCK + 8;          // V row stride (bf16): 48 bytes, conflict-free ldmatrix
constexpr int kUS = kTN + 8;          // U row stride: 144 bytes
constexpr int kVPos = kTM * kVS;      // elements per position of the V slice
constexpr int kUPos = kCK * kUS;      // elements per position of the U slice
constexpr int kXPos = kTM * kCK;      // elements per patch pixel of the X slice
constexpr int kMS = kTN + 8;          // M row stride (fp32): conflict-free float2 stores

// The steps' V, two U buffers and two X (patch) buffers; then M, over them.
template <typename T>
constexpr size_t smem_bytes() {
  const size_t steps =
      (size_t)16 * (kVPos + 2 * kUPos) * sizeof(bf16) + (size_t)2 * 16 * kXPos * sizeof(T);
  const size_t m = (size_t)16 * kTM * kMS * sizeof(float);
  return steps > m ? steps : m;
}

struct WinoParams {
  const void* x;      // (N, H, W, C)
  const bf16* u;      // (16, C, Cop), Cop = Co rounded up to 8 (zeros past Co)
  const float* bias;  // (Co) or null
  void* y;            // (N, H, W, Co)
  int N, H, W, C, Co, Cop;
  int T;              // tiles
};

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* y, long long off, float v0, float v1, bool both,
                                           bool pair) {
  if (pair && both) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  if constexpr (sizeof(T) == 4) {
    y[off] = v0;
    if (both) y[off + 1] = v1;
  } else {
    y[off] = __float2bfloat16_rn(v0);
    if (both) y[off + 1] = __float2bfloat16_rn(v1);
  }
}

// One output row of a tile: A^T along its columns, (A^T M)[row][b] = r[b]
// -> the pixels at column parity 0 (at `off`) and 1 (one pixel, `px`
// elements, further), two channels each, plus the bias.
template <typename T>
__device__ __forceinline__ void store_out_row(T* y, long long off, int px, const float2 (&r)[4],
                                              float b0, float b1, bool both, bool pair) {
  store_pair(y, off, r[0].x + r[1].x + r[2].x + b0, r[0].y + r[1].y + r[2].y + b1, both, pair);
  store_pair(y, off + px, r[1].x - r[2].x - r[3].x + b0, r[1].y - r[2].y - r[3].y + b1, both,
             pair);
}

// B^T applied along one axis of a 4x4 patch (B^T rows: [1 0 -1 0],
// [0 1 1 0], [0 -1 1 0], [0 1 0 -1]).
__device__ __forceinline__ void bt4(const float2 (&v)[4], float2 (&o)[4]) {
  o[0] = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  o[1] = make_float2(v[1].x + v[2].x, v[1].y + v[2].y);
  o[2] = make_float2(v[2].x - v[1].x, v[2].y - v[1].y);
  o[3] = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
}

// The block's tiles: the pixel index of each tile's top-left output pixel
// and its row and column (row -4 for a tile past T: its whole patch is
// outside the image).
struct Tiles {
  long long pix[kTM];
  int row[kTM], col[kTM];
};

// One step's X slice: the 16 patch pixels q = 4 r + s of each tile, kCK
// channels from c0, [q][tile][channel] in T, zero outside the image and past
// C. With rows of C a multiple of 16 bytes, 16-byte cp.async copies (in the
// caller's group); otherwise element by element.
template <typename T>
__device__ __forceinline__ void stage_x(const WinoParams& p, const Tiles& tl, T* xs, int c0,
                                        int tid) {
  const T* x = static_cast<const T*>(p.x);
  if ((p.C * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);  // elements per vector
    constexpr int kVecs = kCK / kPer;
    for (int it = tid; it < 16 * kTM * kVecs; it += kThreads) {
      const int v = it % kVecs, m = (it / kVecs) % kTM, q = it / (kVecs * kTM);
      const int yy = tl.row[m] - 1 + q / 4, xx = tl.col[m] - 1 + q % 4;
      const int c = c0 + v * kPer;
      const bool valid = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W && c < p.C;
      const T* src = x + (tl.pix[m] + (long long)(q / 4 - 1) * p.W + (q % 4 - 1)) * p.C + c;
      cp_async16(xs + (q * kTM + m) * kCK + v * kPer, valid ? src : x, valid);
    }
  } else {
    for (int it = tid; it < 16 * kTM * kCK; it += kThreads) {
      const int ch = it % kCK, m = (it / kCK) % kTM, q = it / (kCK * kTM);
      const int yy = tl.row[m] - 1 + q / 4, xx = tl.col[m] - 1 + q % 4;
      const int c = c0 + ch;
      T v = T(0.f);
      if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W && c < p.C)
        v = x[(tl.pix[m] + (long long)(q / 4 - 1) * p.W + (q % 4 - 1)) * p.C + c];
      xs[(q * kTM + m) * kCK + ch] = v;
    }
  }
}

// One step's U slice: 16 positions x kCK rows x kTN columns, 16-byte
// cp.async copies, zero past C and Cop.
__device__ __forceinline__ void stage_u(const WinoParams& p, bf16* us, int n0, int c0, int tid) {
  constexpr int kVecs = kTN / 8;
  for (int it = tid; it < 16 * kCK * kVecs; it += kThreads) {
    const int v = it % kVecs, r = (it / kVecs) % kCK, pos = it / (kVecs * kCK);
    const int c = c0 + r, col = n0 + v * 8;
    const bool valid = c < p.C && col < p.Cop;
    const bf16* src = p.u + ((long long)pos * p.C + c) * p.Cop + col;
    cp_async16(us + pos * kUPos + r * kUS + v * 8, valid ? src : p.u, valid);
  }
}

// The V slice from the X slice: one item is a (tile, channel pair): its 16
// patch values, then B^T d B, stored as bf16 [position][tile][channel].
template <typename T>
__device__ __forceinline__ void transform_v(const T* xs, bf16* vs, int tid) {
  constexpr int kPairs = kCK / 2;
  for (int it = tid; it < kTM * kPairs; it += kThreads) {
    const int m = it / kPairs, c = 2 * (it % kPairs);
    float2 rows[4][4];  // rows[r][b] = (d B)[r][b]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float2 d[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) d[s] = ld2(xs + ((4 * r + s) * kTM + m) * kCK + c);
      bt4(d, rows[r]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float2 col[4] = {rows[0][b], rows[1][b], rows[2][b], rows[3][b]};
      float2 v[4];  // v[a] = V[a][b]
      bt4(col, v);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<uint32_t*>(vs + (a * 4 + b) * kVPos + m * kVS + c) =
            pack_bf16(v[a].x, v[a].y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) winograd_kernel(const WinoParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* vs = reinterpret_cast<bf16*>(smem_raw);
  bf16* us = vs + 16 * kVPos;                                 // two buffers
  T* xs = reinterpret_cast<T*>(us + 2 * 16 * kUPos);          // two buffers
  __shared__ Tiles tl;

  const int n_co = (p.Co + kTN - 1) / kTN;
  const int tile0 = (blockIdx.x / n_co) * kTM;
  const int n0 = (blockIdx.x % n_co) * kTN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pg = warp % kGroups, wn = warp / kGroups;  // positions kPG pg.., channels 32 wn..

  if (tid < kTM) {
    const int t = tile0 + tid;
    const int h2 = p.H / 2, w2 = p.W / 2;
    if (t < p.T) {
      const int n = t / (h2 * w2), rem = t % (h2 * w2);
      const int i = rem / w2, j = rem % w2;
      tl.pix[tid] = ((long long)n * p.H + 2 * i) * p.W + 2 * j;
      tl.row[tid] = 2 * i;
      tl.col[tid] = 2 * j;
    } else {
      tl.pix[tid] = 0;
      tl.row[tid] = -4;
      tl.col[tid] = 0;
    }
  }
  __syncthreads();

  // ldmatrix addresses: V (the A operand, tiles x channels) and U (the B
  // operand, channels x outputs, transposed on the way), as in the flash
  // kernels' QK^T and PV.
  const int a_off = (lane & 15) * kVS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kUS + wn * 32 + (lane >> 4) * 8;

  float acc[kPG][2][4][4];  // [position][16-tile m-tile][8-channel n-tile]
#pragma unroll
  for (int i = 0; i < kPG; ++i)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][mt][nt][e] = 0.f;

  const int steps = (p.C + kCK - 1) / kCK;
  stage_u(p, us, n0, 0, tid);
  stage_x<T>(p, tl, xs, 0, tid);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {  // the next step's slices, in flight during this one
      stage_u(p, us + (buf ^ 1) * 16 * kUPos, n0, (s + 1) * kCK, tid);
      stage_x<T>(p, tl, xs + (buf ^ 1) * 16 * kXPos, (s + 1) * kCK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    transform_v<T>(xs + buf * 16 * kXPos, vs, tid);
    __syncthreads();
    const bf16* ub = us + buf * 16 * kUPos;
#pragma unroll
    for (int i = 0; i < kPG; ++i) {
      const int k = pg * kPG + i;
#pragma unroll
      for (int ks = 0; ks < kCK / 16; ++ks) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], vs + k * kVPos + mt * 16 * kVS + a_off + ks * 16);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          ldmatrix_x4_trans(b[n2], ub + k * kUPos + ks * 16 * kUS + b_off + n2 * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            mma_bf16(acc[i][mt][2 * n2], a[mt], b[n2][0], b[n2][1]);
            mma_bf16(acc[i][mt][2 * n2 + 1], a[mt], b[n2][2], b[n2][3]);
          }
      }
    }
    __syncthreads();  // every warp is done with this step's buffers before their refill
  }

  // M to shared memory, over the step buffers, [position][tile][channel]:
  // lane (g, tg) holds tiles g and g + 8 of each m-tile, channels 2 tg and
  // 2 tg + 1 of each n-tile.
  float* ms = reinterpret_cast<float*>(smem_raw);
  {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int i = 0; i < kPG; ++i)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* row = ms + ((pg * kPG + i) * kTM + mt * 16 + g) * kMS + wn * 32 + nt * 8 + 2 * tg;
          *reinterpret_cast<float2*>(row) = make_float2(acc[i][mt][nt][0], acc[i][mt][nt][1]);
          *reinterpret_cast<float2*>(row + 8 * kMS) =
              make_float2(acc[i][mt][nt][2], acc[i][mt][nt][3]);
        }
  }
  __syncthreads();

  // Y = A^T M A, the bias and the store, one (tile, channel pair) per item,
  // channels fastest: a warp writes 64 channels of one tile's 4 pixels.
  T* y = static_cast<T*>(p.y);
  const bool pair = (p.Co % 2) == 0;
  for (int it = tid; it < kTM * (kTN / 2); it += kThreads) {
    const int m = it / (kTN / 2), c = 2 * (it % (kTN / 2));
    const int co = n0 + c;
    if (tl.row[m] < 0 || co >= p.Co) continue;  // past T or Co
    const bool both = co + 1 < p.Co;
    float2 r0[4], r1[4];  // (A^T M)[row parity][b]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float2 m0 = ld2(ms + (b * kTM + m) * kMS + c);
      const float2 m1 = ld2(ms + ((4 + b) * kTM + m) * kMS + c);
      const float2 m2 = ld2(ms + ((8 + b) * kTM + m) * kMS + c);
      const float2 m3 = ld2(ms + ((12 + b) * kTM + m) * kMS + c);
      r0[b] = make_float2(m0.x + m1.x + m2.x, m0.y + m1.y + m2.y);
      r1[b] = make_float2(m1.x - m2.x - m3.x, m1.y - m2.y - m3.y);
    }
    float b0 = 0.f, b1 = 0.f;
    if (p.bias != nullptr) {
      b0 = p.bias[co];
      b1 = both ? p.bias[co + 1] : 0.f;
    }
    const long long off = tl.pix[m] * p.Co + co;
    store_out_row(y, off, p.Co, r0, b0, b1, both, pair);
    store_out_row(y, off + (long long)p.W * p.Co, p.Co, r1, b0, b1, both, pair);
  }
}

template <typename T>
int launch(const WinoParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(winograd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  winograd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) bf16 (dtype 0) or fp32 (1), contiguous, 16-byte aligned;
// u (16, C, Cop) bf16, Cop = Co rounded up to a multiple of 8, zero past
// Co; bias (Co) fp32 or null; y (N, H, W, Co) in x's type. H and W even.
extern "C" int hallo_winograd_conv3x3(const void* x, const void* u, const void* bias, void* y,
                                      int N, int H, int W, int C, int Co, int Cop, int dtype,
                                      void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || Co <= 0 || Cop < Co ||
      Cop % 8 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long T = (long long)N * (H / 2) * (W / 2);
  const long long blocks = (T + kTM - 1) / kTM * ((Co + kTN - 1) / kTN);
  if (T > INT_MAX - kTM || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  WinoParams p;
  p.x = x;
  p.u = static_cast<const bf16*>(u);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.N = N; p.H = H; p.W = W; p.C = C; p.Co = Co; p.Cop = Cop;
  p.T = (int)T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<bf16>(p, blocks, s) : launch<float>(p, blocks, s);
}
