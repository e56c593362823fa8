// Fused 1x1 convolution + batch-norm statistics, and the batch-norm apply +
// residual + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces: the two Pallas TPU kernels of paddle_tpu/ops/fused_conv1x1_bn.py
//   * _conv1x1_bn_stats (_kernel; public entry conv1x1_bn_stats):
//       Y = X @ W for X [M, K], W [K, N] (a 1x1 stride-1 NHWC convolution
//       flattened), and per column sum(y) and sum(y*y) in float32 taken from
//       the float32 ACCUMULATOR, before y is rounded to the activation type;
//   * _bn_apply (_apply_kernel; public entry bn_apply_relu):
//       out = relu(y * scale[n] + shift[n] (+ residual)), float32 math, one
//       rounding to y's type at the end.
// ResNet-50 runs the pair in the conv3 -> bn3 -> +identity -> relu tail of
// every bottleneck block during training (16 launches of each a step).
//
// What bounds them on an H100: bytes.  conv1x1_bn_stats at ResNet-50's B=128
// shapes does 2*M*K*N flops on 2*M*K + 2*K*N + 2*M*N bytes (bf16): 32 to 128
// flops a byte, far under the card's ~295 bf16 flops-per-byte ridge (layer1:
// 13.2 GFLOP in 13 us at 989 TFLOP/s against 257 MB in 77 us at 3.35 TB/s).
// bn_apply_relu is elementwise: 6*M*N bytes with the residual.
//
// What this first design does about it:
//   * stats kernel (bf16): 128x128 output tiles, 8 warps each computing 32x64
//     with WMMA 16x16x16 bf16 tensor-core products into float32
//     accumulators; K walked in 32-wide slices staged in shared memory, the
//     next slice loaded into registers (16-byte loads) while the current one
//     is multiplied.  The epilogue parks the float32 tile in shared memory,
//     writes y with 16-byte stores and sums each column of the tile from the
//     float32 values.  Y is written once and never read back for the stats,
//     which is the pass the fusion saves.  float32 inputs take a SIMT FMA
//     path (64x64 tiles, 4x4 outputs a thread); TF32 is never used.
//   * determinism: no float atomics.  A block walks a fixed run of M tiles
//     in order and writes one partial row of column sums into a
//     [splits, N] float32 workspace; a second small launch adds the rows in
//     a fixed order.  Two runs give the same bits.
//   * any M, K and N: every load and store is bounds-checked, with 16-byte
//     vectors only where the wrapper says the rows are 16-byte aligned; the
//     TPU's 8/128 padding is not carried over.
//   * bn_apply: grid-stride 16-byte vector loads and stores, scale and shift
//     read per column (they stay in L1/L2); __fmul_rn / __fadd_rn in the
//     order the plain version runs them, (y*sc + sh) + r, so the result is
//     bit-equal to it: no FMA contraction.
// Not done yet (later work): wgmma, TMA, a persistent schedule, cp.async.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entries,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// ---------------------------------------------------------------------------
// The shared epilogue of both stats kernels: the tile's float32 values sit in
// Cs [BM][c_ld].  Writes y (16-byte vectors where allowed) and adds each
// column's sum and sum of squares over the tile's valid rows to the calling
// thread's running pair.  Thread t owns column t % BN and the rows of group
// t / BN.
template <typename T, int BM, int BN>
__device__ __forceinline__ void tile_epilogue(const float* Cs, int c_ld, T* y,
                                              int m0, int n0, int M, int N,
                                              int vec, float& run_s,
                                              float& run_q) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int TPR = BN / VEC;          // threads a row
  constexpr int RPP = kThreads / TPR;    // rows a pass
  const int tid = threadIdx.x;
  const int c = (tid % TPR) * VEC;
  for (int r = tid / TPR; r < BM; r += RPP) {
    const int m = m0 + r;
    if (m >= M) break;
    const int n = n0 + c;
    const float* src = Cs + r * c_ld + c;
    T* dst = y + (size_t)m * N + n;
    if (vec && n + VEC <= N) {
      if constexpr (sizeof(T) == 2) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        uint4 o;
        o.x = pack_bf16x2(a.x, a.y);
        o.y = pack_bf16x2(a.z, a.w);
        o.z = pack_bf16x2(b.x, b.y);
        o.w = pack_bf16x2(b.z, b.w);
        *reinterpret_cast<uint4*>(dst) = o;
      } else {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (n + j < N) dst[j] = from_f32<T>(src[j]);
    }
  }
  constexpr int GROUPS = kThreads / BN;
  constexpr int ROWS = BM / GROUPS;
  const int col = tid % BN;
  const int g = tid / BN;
  const int r_end = min(ROWS * (g + 1), M - m0);
  float s = 0.f, q = 0.f;
  for (int r = ROWS * g; r < r_end; ++r) {
    const float v = Cs[r * c_ld + col];
    s += v;
    q += v * v;
  }
  run_s += s;
  run_q += q;
}

// After the M tiles: combine the thread groups of each column in a fixed
// order and write the block's partial row.
template <int BN>
__device__ __forceinline__ void write_partials(float run_s, float run_q,
                                               float* red, float* psum,
                                               float* psq, int n0, int N) {
  const int tid = threadIdx.x;
  red[tid] = run_s;
  red[kThreads + tid] = run_q;
  __syncthreads();
  if (tid < BN && n0 + tid < N) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < kThreads / BN; ++g) {
      s += red[g * BN + tid];
      q += red[kThreads + g * BN + tid];
    }
    psum[(size_t)blockIdx.y * N + n0 + tid] = s;
    psq[(size_t)blockIdx.y * N + n0 + tid] = q;
  }
}

// ---------------------------------------------------------------------------
// bf16: WMMA tensor cores.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kALd = kBK + 8;   // bf16 elements a row of the A tile
constexpr int kBLd = kBN + 8;   // ... of the B tile
constexpr int kCLd = kBN + 4;   // float elements a row of the C tile
constexpr int kPipeBytes = 2 * (kBM * kALd + kBK * kBLd) * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBf16 = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

__device__ __forceinline__ uint4 pack8(const uint16_t (&t)[8]) {
  return make_uint4((uint32_t)t[0] | ((uint32_t)t[1] << 16),
                    (uint32_t)t[2] | ((uint32_t)t[3] << 16),
                    (uint32_t)t[4] | ((uint32_t)t[5] << 16),
                    (uint32_t)t[6] | ((uint32_t)t[7] << 16));
}

// A slice [kBM, kBK] as 512 16-byte chunks, two a thread.
__device__ __forceinline__ void load_a(uint4 (&ra)[2], const uint16_t* x,
                                       int m0, int k0, int M, int K, int vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int m = m0 + (c >> 2);
    const int k = k0 + (c & 3) * 8;
    if (vec && m < M && k + 8 <= K) {
      ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
    } else {
      uint16_t t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : 0;
      ra[i] = pack8(t);
    }
  }
}

// A slice [kBK, kBN] of W, two chunks a thread.
__device__ __forceinline__ void load_b(uint4 (&rb)[2], const uint16_t* w,
                                       int k0, int n0, int K, int N, int vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int k = k0 + (c >> 4);
    const int n = n0 + (c & 15) * 8;
    if (vec && k < K && n + 8 <= N) {
      rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
    } else {
      uint16_t t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = (k < K && n + j < N) ? w[(size_t)k * N + n + j] : 0;
      rb[i] = pack8(t);
    }
  }
}

__device__ __forceinline__ void store_ab(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                         const uint4 (&ra)[2],
                                         const uint4 (&rb)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(As + (c >> 2) * kALd + (c & 3) * 8) = ra[i];
    *reinterpret_cast<uint4*>(Bs + (c >> 4) * kBLd + (c & 15) * 8) = rb[i];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
stats_bf16_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ psum,
                  float* __restrict__ psq, int M, int K, int N,
                  int tiles_per_block, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2 * kThreads];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][ALd]
  __nv_bfloat16* Bs = As + 2 * kBM * kALd;                      // [2][BK][BLd]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][CLd]

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's 32 x 64 piece of the tile
  const int wn = (warp & 1) * 64;
  const int n0 = blockIdx.x * kBN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int mt_end = min((int)(blockIdx.y + 1) * tiles_per_block, m_tiles);
  const int k_tiles = (K + kBK - 1) / kBK;
  float run_s = 0.f, run_q = 0.f;

  for (int mt = blockIdx.y * tiles_per_block; mt < mt_end; ++mt) {
    const int m0 = mt * kBM;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    uint4 ra[2], rb[2];
    load_a(ra, x, m0, 0, M, K, vec);
    load_b(rb, w, 0, n0, K, N, vec);
    store_ab(As, Bs, ra, rb);
    __syncthreads();
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt & 1;
      const bool more = kt + 1 < k_tiles;
      if (more) {  // the next slice's loads fly while this one multiplies
        load_a(ra, x, m0, (kt + 1) * kBK, M, K, vec);
        load_b(rb, w, (kt + 1) * kBK, n0, K, N, vec);
      }
      const __nv_bfloat16* a_s = As + s * kBM * kALd;
      const __nv_bfloat16* b_s = Bs + s * kBK * kBLd;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_s + (wm + i * 16) * kALd + kk, kALd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], b_s + kk * kBLd + wn + j * 16, kBLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if (more)
        store_ab(As + (s ^ 1) * kBM * kALd, Bs + (s ^ 1) * kBK * kBLd, ra, rb);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (wm + i * 16) * kCLd + wn + j * 16,
                                acc[i][j], kCLd, wmma::mem_row_major);
    __syncthreads();
    tile_epilogue<__nv_bfloat16, kBM, kBN>(Cs, kCLd, y, m0, n0, M, N, vec,
                                           run_s, run_q);
    __syncthreads();  // Cs overlays the next tile's slices
  }
  write_partials<kBN>(run_s, run_q, red, psum, psq, n0, N);
}

// ---------------------------------------------------------------------------
// float32: SIMT FMAs, 64 x 64 tiles, 4 x 4 outputs a thread (rows ty + 16i,
// columns tx + 16j, so shared-memory reads are broadcasts or conflict-free).
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFLd = 68;
constexpr int kFSmem = (2 * kFBK * kFLd > kFBM * kFLd) ? 2 * kFBK * kFLd
                                                       : kFBM * kFLd;

__global__ void __launch_bounds__(kThreads)
stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, float* __restrict__ psum,
                 float* __restrict__ psq, int M, int K, int N,
                 int tiles_per_block, int vec) {
  __shared__ __align__(16) float smem[kFSmem];
  __shared__ float red[2 * kThreads];
  float* As = smem;                 // [BK][Ld], A transposed
  float* Bs = smem + kFBK * kFLd;   // [BK][Ld]
  float* Cs = smem;                 // [BM][Ld]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * kFBN;
  const int m_tiles = (M + kFBM - 1) / kFBM;
  const int mt_end = min((int)(blockIdx.y + 1) * tiles_per_block, m_tiles);
  float run_s = 0.f, run_q = 0.f;

  for (int mt = blockIdx.y * tiles_per_block; mt < mt_end; ++mt) {
    const int m0 = mt * kFBM;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kFBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * kThreads;
        const int m = m0 + (e >> 4), k = k0 + (e & 15);
        As[(e & 15) * kFLd + (e >> 4)] =
            (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
        const int kb = k0 + (e >> 6), n = n0 + (e & 63);
        Bs[(e >> 6) * kFLd + (e & 63)] =
            (kb < K && n < N) ? w[(size_t)kb * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k * kFLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k * kFLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * kFLd + tx + 16 * j] = acc[i][j];
    __syncthreads();
    tile_epilogue<float, kFBM, kFBN>(Cs, kFLd, y, m0, n0, M, N, vec, run_s,
                                     run_q);
    __syncthreads();
  }
  write_partials<kFBN>(run_s, run_q, red, psum, psq, n0, N);
}

// Adds the [splits, N] partial rows in a fixed order: 32 columns x 8 row
// lanes a block, each lane summing rows lane, lane + 8, ...; then lane 0
// adds the 8 lane sums in order.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ psum,
                       const float* __restrict__ psq, int splits, int N,
                       float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float red[2][8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (col < N) {
    for (int r = lane; r < splits; r += 8) {
      s += psum[(size_t)r * N + col];
      q += psq[(size_t)r * N + col];
    }
  }
  red[0][lane][threadIdx.x] = s;
  red[1][lane][threadIdx.x] = q;
  __syncthreads();
  if (lane == 0 && col < N) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      ts += red[0][l][threadIdx.x];
      tq += red[1][l][threadIdx.x];
    }
    sum[col] = ts;
    sumsq[col] = tq;
  }
}

// ---------------------------------------------------------------------------
// bn_apply: out = relu((y * sc + sh) + r), float32 math, separately rounded.
template <typename T, bool HAS_RES>
__device__ __forceinline__ T apply_one(T yv, float sc, float sh, T rv) {
  float t = __fadd_rn(__fmul_rn(to_f32(yv), sc), sh);
  if (HAS_RES) t = __fadd_rn(t, to_f32(rv));
  return from_f32<T>(t < 0.f ? 0.f : t);
}

template <typename T, bool HAS_RES>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                const float* __restrict__ shift, const T* __restrict__ res,
                T* __restrict__ out, int64_t total, int N, int vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (vec) {  // N % VEC == 0: a vector never crosses a row
    const int64_t nvec = total / VEC;
    for (int64_t v = first; v < nvec; v += stride) {
      const int64_t base = v * VEC;
      const int c = (int)(base % N);
      const uint4 yv = reinterpret_cast<const uint4*>(y)[v];
      const uint4 rv = HAS_RES ? reinterpret_cast<const uint4*>(res)[v] : yv;
      const T* ye = reinterpret_cast<const T*>(&yv);
      const T* re = reinterpret_cast<const T*>(&rv);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        oe[j] = apply_one<T, HAS_RES>(ye[j], scale[c + j], shift[c + j], re[j]);
      reinterpret_cast<uint4*>(out)[v] = ov;
    }
  } else {
    for (int64_t i = first; i < total; i += stride) {
      const int c = (int)(i % N);
      out[i] = apply_one<T, HAS_RES>(y[i], scale[c], shift[c],
                                     HAS_RES ? res[i] : y[i]);
    }
  }
}

template <typename T>
cudaError_t launch_apply(const void* y, const float* sc, const float* sh,
                         const void* r, void* out, int64_t total, int N,
                         int vec, int blocks, cudaStream_t st) {
  if (r != nullptr)
    bn_apply_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(y), sc, sh, static_cast<const T*>(r),
        static_cast<T*>(out), total, N, vec);
  else
    bn_apply_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(y), sc, sh, nullptr, static_cast<T*>(out),
        total, N, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  Layouts, all
// contiguous: x [M, K], w [K, N], y [M, N]; psum, psq [splits, N] float32
// workspace; sum, sumsq [N] float32.  Block tiles are 64 x 64 (float32) or
// 128 x 128 (bf16); each block walks `tiles_per_block` consecutive M tiles
// and splits = ceil(ceil(M / tile) / tiles_per_block).  vec != 0 promises K
// and N are multiples of 16 bytes' worth of elements and every base address
// is 16-byte aligned.  Two launches on `stream`, no synchronisation; returns
// the first launch error.
extern "C" int conv1x1_bn_stats_fwd(int dtype, const void* x, const void* w,
                                    void* y, void* psum, void* psq, void* sum,
                                    void* sumsq, int M, int K, int N,
                                    int tiles_per_block, int vec,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || tiles_per_block <= 0)
    return cudaErrorInvalidValue;
  const int tile = dtype == 1 ? kBM : kFBM;
  const int m_tiles = (M + tile - 1) / tile;
  const int splits = (m_tiles + tiles_per_block - 1) / tiles_per_block;
  if (splits > 65535) return cudaErrorInvalidValue;
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  if (dtype == 1) {
    // above 48 KB of dynamic shared memory only when asked for (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        stats_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBf16);
    if (e != cudaSuccess) return e;
    const dim3 grid((N + kBN - 1) / kBN, splits);
    stats_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        static_cast<__nv_bfloat16*>(y), ps, pq, M, K, N, tiles_per_block,
        vec);
  } else if (dtype == 0) {
    const dim3 grid((N + kFBN - 1) / kFBN, splits);
    stats_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), ps, pq, M, K, N, tiles_per_block, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_partials_kernel<<<(N + 31) / 32, dim3(32, 8), 0, st>>>(
      ps, pq, splits, N, static_cast<float*>(sum), static_cast<float*>(sumsq));
  return cudaGetLastError();
}

extern "C" const char* conv1x1_bn_stats_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (y, residual and out share it).  y, out
// and residual (nullptr for none) [M, N] contiguous; scale, shift [N]
// float32.  vec != 0 promises N is a multiple of 16 bytes' worth of
// elements and every base address is 16-byte aligned.
extern "C" int bn_apply_relu_fwd(int dtype, const void* y, const void* scale,
                                 const void* shift, const void* residual,
                                 void* out, long long M, int N, int vec,
                                 int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int64_t total = (int64_t)M * N;
  if (dtype == 0)
    return launch_apply<float>(y, sc, sh, residual, out, total, N, vec,
                               blocks, st);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(y, sc, sh, residual, out, total, N,
                                       vec, blocks, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* bn_apply_relu_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
