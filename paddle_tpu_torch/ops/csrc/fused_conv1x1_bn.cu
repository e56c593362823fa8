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
// What bounds them on an H100.  conv1x1_bn_stats at ResNet-50's B=128
// shapes does 2*M*K*N flops on 2*M*K + 2*K*N + 2*M*N bytes (bf16): 51, 102
// and 203 flops a byte at layers 1-3, under the card's ~295 bf16
// flops-per-byte ridge, so bytes (layer1: 13.2 GFLOP in 13 us at 989
// TFLOP/s against 257 MB in 77 us at 3.35 TB/s); 384 at layer4, so
// operations there (13.2 GFLOP in 13 us against 34 MB in 10 us).
// bn_apply_relu is elementwise: 6*M*N bytes with the residual.
//
// The Hopper designs (the wrapper, ops/fused_conv1x1_bn.py, picks one by
// shape before the launch; everything else takes the first design below):
//   * conv1x1_bn_stats, bf16 with K and N multiples of 8 and 16-byte-aligned
//     x, w, y (what TMA takes; stats_bf16_wgmma_kernel, entry
//     conv1x1_bn_stats_wgmma): grouped_matmul.cu's persistent block
//     (hopper_sm90.cuh) with one group.  One block an SM; a producer
//     warpgroup, one thread of which keeps a ring of 128-byte-swizzled
//     TMA boxes full (x as 128-row x 64-k boxes, w as 64-k x 64- or
//     128-column boxes), two consumer warpgroups on wgmma m64n128k16 with
//     both operands in shared memory.  Tiles are 128 x 256 where N is a
//     multiple of 256 (each consumer warpgroup takes 128 columns of all
//     128 rows; 3 stages; 3-11% faster than 128 x 128 at ResNet's conv3
//     shapes), else 128 x 128 (each takes 64 rows; 5 stages).  w is read
//     in the layout it comes in, with no copy: a contiguous [K, N] w is
//     the MN-major B operand (the transpose bit); the .t() view of a
//     contiguous [N, K] weight, which is what ResNet passes, is the
//     K-major one.  The epilogue rounds the float32 sums to bf16 once,
//     stages them in shared memory in TMA's swizzle and stores them by
//     TMA, so the next tile's products start while the store runs.  x and
//     w are loaded with the L2's evict-last policy (other column tiles
//     read them again), y stored with evict-first (written once).  Rows
//     past M arrive as zeros (they add 0 to the sums) and the TMA store
//     does not write them.
//     The column statistics come from the float32 accumulators, before
//     the rounding: a consumer thread holds columns 8j + 2t and + 1 of its
//     rows (two a 64-row half), and keeps a running sum and sum of
//     squares of its 32 columns in registers over the M tiles its block
//     walks within one column tile.  The block walks a contiguous run of
//     the tiles in column-tile-major order (fixed by the grid and the
//     shape), so it touches few column tiles; when it leaves one it adds
//     its lanes (a fixed shuffle tree) and the warps that hold the same
//     columns (in order, through shared memory) and writes one partial
//     row for that column tile into the [blocks, N] workspace.
//     reduce_partials_kernel then adds, for each column, the rows of the
//     blocks that touched its column tile, in a fixed order.  No float
//     atomics: two calls give the same bits.
//   * bn_apply_relu with N a multiple of 16 bytes' worth of elements and
//     16-byte-aligned y, residual, out (bn_apply_resident_kernel, entry
//     bn_apply_relu_resident): each thread owns one 16-byte chunk of
//     columns for the whole call, loads that chunk's scale and shift into
//     registers once (in the dtype they come in: the bf16 ones the tail
//     folds need no float32 copy, which took two more launches), then
//     walks rows with a stride, 8 rows a turn, so 16 16-byte loads of y
//     and the residual are in flight.  Plain loads: the evict-first hint
//     (ld.global.cs) measured 4-5% slower at ResNet's layers 1-3 (13 of
//     the 16 launches a step) and 7% faster at layer4.  The
//     arithmetic and its order are the first design's: bit-equal to the
//     plain version.
//
// The first design:
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
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entries,
// bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

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

// The Hopper stats kernel's walk: block b of `blocks` takes tiles
// [b * tiles / blocks, (b + 1) * tiles / blocks) of the column-tile-major
// order (tile i: column tile i / tiles_m, row tile i % tiles_m).
__device__ __forceinline__ int walk_start(int b, int blocks, int tiles) {
  return (int)((long long)b * tiles / blocks);
}

// The block whose run holds tile i.
__device__ __forceinline__ int walk_block(int i, int blocks, int tiles) {
  return (int)(((long long)(i + 1) * blocks - 1) / tiles);
}

// Adds the [splits, N] partial rows in a fixed order: 32 columns x 8 row
// lanes a block, each lane summing rows lo + lane, lo + lane + 8, ... below
// hi; then lane 0 adds the 8 lane sums in order.  tiles_m == 0: every row
// (the first design); otherwise the rows of the blocks of the Hopper walk
// that touched the column's tile (tile_n columns wide).
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ psum,
                       const float* __restrict__ psq, int splits, int N,
                       float* __restrict__ sum, float* __restrict__ sumsq,
                       int tile_n, int tiles_m, int tiles) {
  __shared__ float red[2][8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (col < N) {
    int lo = 0, hi = splits;
    if (tiles_m > 0) {
      const int nt = col / tile_n;
      lo = walk_block(nt * tiles_m, splits, tiles);
      hi = walk_block((nt + 1) * tiles_m - 1, splits, tiles) + 1;
    }
    for (int r = lo + lane; r < hi; r += 8) {
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

// The resident design: thread gt owns 16-byte column chunk gt % cpr of
// every row lane, lane + lanes, ... (lane = gt / cpr), its scale and shift
// (S: float or bf16, read as they are: bf16 to float is exact) in
// registers, loaded once, after the first turn's loads are issued; 8 rows
// a turn, all loads of a turn issued before any use.
constexpr int kApplyRows = 8;

template <typename T, typename S, bool HAS_RES>
__global__ void __launch_bounds__(kThreads)
bn_apply_resident_kernel(const T* __restrict__ y, const S* __restrict__ scale,
                         const S* __restrict__ shift,
                         const T* __restrict__ res, T* __restrict__ out,
                         int M, int N) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int cpr = N / VEC;  // 16-byte chunks a row
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int lanes = gridDim.x * kThreads / cpr;
  if (gt >= lanes * cpr) return;
  const int c = gt % cpr, lane = gt / cpr;
  const uint4* yv = reinterpret_cast<const uint4*>(y) + c;
  const uint4* rv = reinterpret_cast<const uint4*>(res) + c;
  uint4* ov = reinterpret_cast<uint4*>(out) + c;
  float sc[VEC], sh[VEC];
  for (int r0 = lane; r0 < M; r0 += kApplyRows * lanes) {
    uint4 a[kApplyRows], b[kApplyRows];
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      const int r = r0 + u * lanes;
      if (r < M) {
        a[u] = yv[(size_t)r * cpr];
        if (HAS_RES) b[u] = rv[(size_t)r * cpr];
      }
    }
    if (r0 == lane) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sc[j] = to_f32(scale[c * VEC + j]);
        sh[j] = to_f32(shift[c * VEC + j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      const int r = r0 + u * lanes;
      if (r < M) {
        const T* ye = reinterpret_cast<const T*>(&a[u]);
        const T* re = reinterpret_cast<const T*>(HAS_RES ? &b[u] : &a[u]);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          oe[j] = apply_one<T, HAS_RES>(ye[j], sc[j], sh[j], re[j]);
        ov[(size_t)r * cpr] = o;
      }
    }
  }
}

template <typename T, typename S>
cudaError_t launch_resident(const void* y, const void* sc, const void* sh,
                            const void* r, void* out, int M, int N,
                            int blocks, cudaStream_t st) {
  const S* scale = static_cast<const S*>(sc);
  const S* shift = static_cast<const S*>(sh);
  if (r != nullptr)
    bn_apply_resident_kernel<T, S, true><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(y), scale, shift, static_cast<const T*>(r),
        static_cast<T*>(out), M, N);
  else
    bn_apply_resident_kernel<T, S, false><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(y), scale, shift, nullptr,
        static_cast<T*>(out), M, N);
  return cudaGetLastError();
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

// ---------------------------------------------------------------------------
// bf16 on Hopper: a persistent walk over the tiles, a TMA ring, wgmma, the
// column statistics in the epilogue
// ---------------------------------------------------------------------------
constexpr int kHM = 128;  // rows a tile
constexpr int kHK = 64;   // k a stage: one 128-byte swizzle atom of x
constexpr int kHXBytes = kHM * kHK * 2;
constexpr int kHRedBytes = 2 * 8 * 128 * 4;

// L2 policies of the TMA traffic: x and w are read again by other column
// tiles (evict last), y is written once (evict first).  Measured at
// ResNet's conv3 shapes: 3.5% faster at layer1, 9% at layer2, the same at
// layers 3-4.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}

// sm90::tma_load / tma_store with an L2 cache policy.
__device__ __forceinline__ void tma_load_hint(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(0), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store_hint(const CUtensorMap* map,
                                               const void* src, int c0,
                                               int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1), "r"(0), "l"(policy)
      : "memory");
}

// A tile is 128 rows x BN columns (128 or 256).  Each consumer warpgroup
// computes H = BN / 128 halves of 64 rows x 128 columns (m64n128k16 each):
// BN 128 splits the rows (warpgroup wg: rows 64 wg.., every column), BN 256
// the columns (warpgroup wg: columns 128 wg.., every row), so a thread
// always holds 32 columns (8j + 2t and + 1) and its statistics stay 64
// registers beside the 64 H accumulators.
// Shared memory (1024-byte aligned, the swizzle's period): STAGES stages of
// x [128 rows][64 k] (one atom) and w (K-major: [BN columns][64 k], one
// atom; MN-major: [BN / 64 atoms][64 k][64 columns]), each consumer
// warpgroup's output staging [H][2 atoms][64 rows][64 columns] (swizzled as
// TMA stores it), the 8 consumer warps' column sums and sums of squares,
// then the barriers.  Warps 0-7 are the two consumer warpgroups; warpgroup
// 2 is the producer.
template <int BN>
struct HTile {
  static constexpr int H = BN / 128;
  static constexpr int STAGES = BN == 128 ? 5 : 3;
  static constexpr int STAGE = kHXBytes + kHK * BN * 2;
  static constexpr int Y_BYTES = H * 64 * 128 * 2;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + 2 * Y_BYTES + kHRedBytes + 2 * STAGES * 8;
};

struct HParams {
  float* psum;  // [blocks, N]: the block's partial row of each column tile
  float* psq;
  int N, tiles_m, tiles, n_kt;
};

// Leaving column tile nt: the 256 consumer threads add their running sums
// over the lanes that share their columns (g, a fixed shuffle tree), then
// over the warps that hold the same columns in order (8 at BN 128, the
// warpgroup's 4 at BN 256), and write the block's partial row.
template <int BN>
__device__ __forceinline__ void flush_stats(float (&rs)[32], float (&rq)[32],
                                            float* red, const HParams& p,
                                            int nt) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int warp = threadIdx.x >> 5;  // 0-7 over both warpgroups
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], off);
      rq[j] += __shfl_xor_sync(0xffffffffu, rq[j], off);
    }
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp * 128 + 8 * n + 2 * t + e] = rs[2 * n + e];
        red[(8 + warp) * 128 + 8 * n + 2 * t + e] = rq[2 * n + e];
      }
  }
  sm90::named_sync(3, sm90::kConsumers);
  if constexpr (BN == 128) {  // thread: column tid % 128, sums or squares
    const int c = threadIdx.x % 128, sq = threadIdx.x / 128;
    const float* src = red + sq * 8 * 128 + c;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) v += src[r * 128];
    const int n = nt * BN + c;
    if (n < p.N) (sq ? p.psq : p.psum)[(size_t)blockIdx.x * p.N + n] = v;
  } else {  // thread: column tid of the tile, in its warpgroup's 4 warps
    const int c = threadIdx.x, wg = c / 128;
    const int n = nt * BN + c;
#pragma unroll
    for (int sq = 0; sq < 2; ++sq) {
      const float* src = red + (sq * 8 + wg * 4) * 128 + c % 128;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) v += src[r * 128];
      if (n < p.N) (sq ? p.psq : p.psum)[(size_t)blockIdx.x * p.N + n] = v;
    }
  }
  sm90::named_sync(3, sm90::kConsumers);  // red is free again
}

template <int BN, bool W_KMAJOR>
__global__ void __launch_bounds__(sm90::kThreadsWg, 1)
stats_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap ty, HParams p) {
  using T = HTile<BN>;
  constexpr int ST = T::STAGES, STAGE = T::STAGE, H = T::H;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = sm90::smem_1024(smem_raw);
  unsigned char* stage_out = ring + ST * STAGE;
  float* red = reinterpret_cast<float*>(stage_out + 2 * T::Y_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * 128);
  uint64_t* empty = full + ST;
  const int first = walk_start(blockIdx.x, gridDim.x, p.tiles);
  const int last = walk_start(blockIdx.x + 1, gridDim.x, p.tiles);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], sm90::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= sm90::kConsumers) {  // the producer warpgroup
    sm90::producer_regs();
    if (threadIdx.x == sm90::kConsumers) {
      const uint64_t keep = l2_policy(true);
      int it = 0;  // stages filled so far, across tiles
      for (int i = first; i < last; ++i) {
        const int nt = i / p.tiles_m, mt = i - nt * p.tiles_m;
        for (int kt = 0; kt < p.n_kt; ++kt, ++it) {
          const int st = it % ST;
          if (it >= ST) sm90::mbar_wait(&empty[st], (it / ST - 1) & 1);
          sm90::mbar_expect_tx(&full[st], STAGE);
          unsigned char* xs = ring + st * STAGE;
          tma_load_hint(xs, &tx, &full[st], kt * kHK, mt * kHM, keep);
          if constexpr (W_KMAJOR) {  // 128-column boxes of [N, K]
#pragma unroll
            for (int b = 0; b < BN / 128; ++b)
              tma_load_hint(xs + kHXBytes + b * 128 * 128, &tw, &full[st],
                            kt * kHK, nt * BN + 128 * b, keep);
          } else {  // 64-column boxes of [K, N]
#pragma unroll
            for (int a = 0; a < BN / 64; ++a)
              tma_load_hint(xs + kHXBytes + a * kHK * 128, &tw, &full[st],
                            nt * BN + 64 * a, kt * kHK, keep);
          }
        }
      }
    }
    return;
  }
  sm90::consumer_regs();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = BN == 128 ? 64 * wg : 0;   // the warpgroup's first row
  const int col0 = BN == 128 ? 0 : 128 * wg;  // and its 128 columns
  float acc[H][64], rs[32], rq[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) rs[j] = rq[j] = 0.f;
  int it = 0;  // stages consumed so far, across tiles
  int cur = first / p.tiles_m;  // the column tile the sums belong to
  for (int i = first; i < last; ++i) {
    const int nt = i / p.tiles_m, mt = i - nt * p.tiles_m;
    if (nt != cur) {
      flush_stats<BN>(rs, rq, red, p, cur);
      cur = nt;
#pragma unroll
      for (int j = 0; j < 32; ++j) rs[j] = rq[j] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[h][v] = 0.f;
    // each stage's k16 products are committed as one group; the stage
    // before is released once at most that group is in flight
    for (int kt = 0; kt < p.n_kt; ++kt, ++it) {
      const int st = it % ST;
      sm90::mbar_wait(&full[st], (it / ST) & 1);
      const unsigned char* xs = ring + st * STAGE + row0 * 128;
      const unsigned char* ws = ring + st * STAGE + kHXBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHK / 16; ++kk) {
        const uint64_t db =
            W_KMAJOR ? sm90::sw128_desc(ws + col0 * 128 + kk * 32, 16, 1024)
                     : sm90::sw128_desc(ws + (col0 / 64) * kHK * 128 +
                                            kk * 2048,
                                        kHK * 128, 1024);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint64_t da =
              sm90::sw128_desc(xs + h * 64 * 128 + kk * 32, 16, 1024);
          if constexpr (W_KMAJOR)
            sm90::wgmma_ss_n128(acc[h], da, db, 1);
          else
            sm90::wgmma_ss_tb_n128(acc[h], da, db, 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (kt > 0) sm90::mbar_arrive(&empty[(it - 1) % ST]);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) sm90::reg_fence(acc[h]);
    sm90::mbar_arrive(&empty[(it - 1) % ST]);  // n_kt >= 1: K >= 8

    // the statistics from the float32 sums, before the rounding (rows
    // past M hold 0)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[h][4 * n + 2 * rr + e];
            rs[2 * n + e] += v;
            rq[2 * n + e] += v * v;
          }
    // y rounded to bf16 once, staged in shared memory and stored by TMA
    // (rows past M and columns past N are clipped); the warpgroup's next
    // tile starts while the store runs
    unsigned char* out = stage_out + wg * T::Y_BYTES;
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // out is free
    sm90::named_sync(1 + wg, 128);
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int rl = warp * 16 + g + 8 * rr;  // row in the half's 64
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<uint32_t*>(
              out + (2 * h + (n >> 3)) * 64 * 128 + rl * 128 +
              (((n & 7) ^ (rl & 7)) << 4) + 4 * t) =
              sm90::pack_bf16(acc[h][4 * n + 2 * rr],
                              acc[h][4 * n + 2 * rr + 1]);
      }
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      const uint64_t once = l2_policy(false);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          if (nt * BN + col0 + 64 * a < p.N)
            tma_store_hint(&ty, out + (2 * h + a) * 64 * 128,
                           nt * BN + col0 + 64 * a, mt * kHM + row0 + 64 * h,
                           once);
      sm90::bulk_commit();
    }
  }
  if (first < last) flush_stats<BN>(rs, rq, red, p, cur);
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the last stores
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int BN, bool W_KMAJOR>
cudaError_t launch_stats_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                              const CUtensorMap& ty, const HParams& p,
                              int blocks, cudaStream_t st) {
  // the shared memory allowed: per device, on its first call (outside any
  // CUDA graph capture)
  static bool allowed[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !allowed[dev]) {
    e = cudaFuncSetAttribute(stats_bf16_wgmma_kernel<BN, W_KMAJOR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HTile<BN>::SMEM);
    allowed[dev] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return e;
  stats_bf16_wgmma_kernel<BN, W_KMAJOR>
      <<<blocks, sm90::kThreadsWg, HTile<BN>::SMEM, st>>>(tx, tw, ty, p);
  return cudaGetLastError();
}

cudaError_t launch_stats_wgmma(const void* x, const void* w, bool w_kmajor,
                               void* y, float* ps, float* pq, float* sum,
                               float* sumsq, int M, int K, int N, int tile_n,
                               int blocks, cudaStream_t st) {
  if (tile_n != 128 && tile_n != 256) return cudaErrorInvalidValue;
  const int tiles_m = (M + kHM - 1) / kHM;
  const long long tiles = (long long)tiles_m * ((N + tile_n - 1) / tile_n);
  if (tiles > 0x7fffffffLL || blocks < 1 || blocks > tiles)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw, ty;
  cudaError_t e = sm90::tensor_map(&tx, x, 1, M, K, kHM);
  if (e == cudaSuccess)
    e = w_kmajor ? sm90::tensor_map(&tw, w, 1, N, K, 128)   // [N, K]
                 : sm90::tensor_map(&tw, w, 1, K, N, kHK);  // [K, N]
  if (e == cudaSuccess) e = sm90::tensor_map(&ty, y, 1, M, N, 64);
  if (e != cudaSuccess) return e;
  const HParams p{ps, pq, N, tiles_m, (int)tiles, (K + kHK - 1) / kHK};
  if (tile_n == 128)
    e = w_kmajor ? launch_stats_tile<128, true>(tx, tw, ty, p, blocks, st)
                 : launch_stats_tile<128, false>(tx, tw, ty, p, blocks, st);
  else
    e = w_kmajor ? launch_stats_tile<256, true>(tx, tw, ty, p, blocks, st)
                 : launch_stats_tile<256, false>(tx, tw, ty, p, blocks, st);
  if (e != cudaSuccess) return e;
  reduce_partials_kernel<<<(N + 31) / 32, dim3(32, 8), 0, st>>>(
      ps, pq, blocks, N, sum, sumsq, tile_n, tiles_m, (int)tiles);
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
    // above 48 KB of dynamic shared memory only when asked for: per
    // device, on its first call (outside any CUDA graph capture)
    static bool allowed[64] = {false};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
    if (e == cudaSuccess && !allowed[dev]) {
      e = cudaFuncSetAttribute(stats_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBf16);
      allowed[dev] = e == cudaSuccess;
    }
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
      ps, pq, splits, N, static_cast<float*>(sum), static_cast<float*>(sumsq),
      0, 0, 0);
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

// bf16 on the TMA ring and wgmma (stats_bf16_wgmma_kernel).  x [M, K], y
// [M, N] contiguous; w [K, N] contiguous (w_kmajor 0) or the storage of a
// contiguous [N, K] weight (w_kmajor 1: the .t() view ResNet passes).
// psum, psq [blocks, N] float32 workspace; sum, sumsq [N] float32.  Tiles
// are 128 rows x tile_n (128 or 256) columns; `blocks` (1 to the number of
// tiles; one an SM) is the grid.  It takes K and N multiples of 8 and
// 16-byte-aligned x, w, y, what TMA needs (the wrapper's choice); anything
// else returns cudaErrorInvalidValue.  Two launches on `stream`, no
// synchronisation.
extern "C" int conv1x1_bn_stats_wgmma(const void* x, const void* w,
                                      int w_kmajor, void* y, void* psum,
                                      void* psq, void* sum, void* sumsq,
                                      int M, int K, int N, int tile_n,
                                      int blocks, void* stream) {
  if (M <= 0 || K < 8 || K % 8 != 0 || N < 8 || N % 8 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  return launch_stats_wgmma(x, w, w_kmajor != 0, y, static_cast<float*>(psum),
                            static_cast<float*>(psq),
                            static_cast<float*>(sum),
                            static_cast<float*>(sumsq), M, K, N, tile_n,
                            blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* conv1x1_bn_stats_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The resident design (bn_apply_resident_kernel).  Layouts as
// bn_apply_relu_fwd's, but scale and shift [N] in sdtype (0 = float32, 1 =
// bfloat16).  It takes N a multiple of 16 bytes' worth of elements,
// 16-byte-aligned y, out and residual, M below 2^30, and a grid of at least
// one thread a 16-byte column chunk (blocks x 256 >= N / vector) and below
// 2^27 threads; anything else returns cudaErrorInvalidValue.
extern "C" int bn_apply_relu_resident(int dtype, int sdtype, const void* y,
                                      const void* scale, const void* shift,
                                      const void* residual, void* out,
                                      long long M, int N, int blocks,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || (sdtype != 0 && sdtype != 1) || M <= 0 ||
      M >= (1ll << 30) || N <= 0 || N % vec != 0 || blocks <= 0 ||
      (long long)blocks * kThreads < N / vec ||
      (long long)blocks * kThreads >= (1ll << 27) || !aligned16(y) ||
      !aligned16(out) || (residual != nullptr && !aligned16(residual)))
    return cudaErrorInvalidValue;
  const int m = (int)M;
  if (dtype == 0)
    return sdtype == 0 ? launch_resident<float, float>(
                             y, scale, shift, residual, out, m, N, blocks, st)
                       : launch_resident<float, __nv_bfloat16>(
                             y, scale, shift, residual, out, m, N, blocks, st);
  return sdtype == 0 ? launch_resident<__nv_bfloat16, float>(
                           y, scale, shift, residual, out, m, N, blocks, st)
                     : launch_resident<__nv_bfloat16, __nv_bfloat16>(
                           y, scale, shift, residual, out, m, N, blocks, st);
}

extern "C" const char* bn_apply_relu_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
