// Grouped matmul over ragged per-expert row groups for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/grouped_matmul.py
// (_kernel :49-59 / _gmm_pallas :62, public entry grouped_matmul).  It
// computes the same function over x [E, C, D], w [E, D, F] and the
// per-expert valid-row counts gs [E] (int32, clamped to [0, C] here):
//   y[e, r, :] = x[e, r, :] . w[e]   for r <  gs[e]   (float32 sum of
//                                                     upcast products)
//   y[e, r, :] = 0                   for r >= gs[e]   (exactly, whatever
//                                                     x's padding holds)
// in x's dtype.  The MoE expert FFN runs it twice a layer: expert e owns
// the first gs[e] rows of its [C, D] capacity bucket and the rest is
// padding.
//
// What bounds it on an H100: operations, at the MoE training shapes.  fc1
// of the slice (8 experts, C = 2560, D = 768, F = 3072, bf16) does
// 2 * sum(gs) * D * F ~ 77 GFLOP on ~45 MB of valid rows, weights and
// output, ~1700 flops a byte, far above the card's ~295 flop/byte bf16
// ridge: the goal is the tensor cores' rate, 989 TFLOP/s bf16, reached
// only through wgmma.  At decode (C = 16, f32) the weights dominate and it
// is bytes.
//
// bf16 with D and F multiples of 8 and 16-byte-aligned bases, what TMA
// takes (gmm_bf16_wgmma_kernel, entry grouped_matmul_wgmma; the wrapper
// chooses it by shape, up front):
//   * flash_attention.cu's warp-specialised block (hopper_sm90.cuh): a
//     producer warpgroup, one thread of which keeps a ring of stages full
//     by TMA (x as 128-row x 64-k boxes of a [E, C, D] tensor map, w as
//     64-k x 64-column boxes of a [E, D, F] one, 128-byte swizzled), and
//     two consumer warpgroups of 64 rows that run wgmma m64n128k16 with
//     both operands in shared memory: x K-major, w MN-major through the
//     transpose bit, so w is never transposed in memory.  128 x 128 tiles
//     (128 x 256 measured no faster at fc1 and 10% slower at fc2, whose
//     F = 768 then leaves 3 column tiles), 5 stages;
//   * persistent: one block per SM walks the tiles, each block taking
//     every gridDim-th; first the tiles that hold some row below gs[e]
//     (expert by expert; counted on the device from gs, no host sync),
//     then the tiles wholly past their group, whose only cost is a zero
//     store by the consumers (no load, no product).  The producer runs
//     ahead across tiles, so a tile's epilogue overlaps the next tile's
//     loads;
//   * epilogue: the float32 sums rounded to bf16 once, rows at or past
//     gs[e] of a partial tile stored as 0 (output row r depends on x's row
//     r alone, so a NaN in padding reaches no valid row), written to
//     shared memory in TMA's swizzled layout and stored by TMA, so the
//     consumers start the next tile while the store runs (stored from
//     registers, 4 bytes a thread, the epilogue took as long as fc1's
//     short k loop).  No split-K and no atomics: two runs give the same
//     bits.
//
// The first design (gmm_bf16_kernel / gmm_f32_kernel / gmm_f32_small_kernel,
// entry grouped_matmul), kept for float32 and for bf16 off TMA's grid: one
// block per (output tile, expert); a tile whose first row is at or past
// gs[e] stores zeros and does no product.  Rows of the padding inside a
// partial tile are loaded as zeros and stored as zeros in the epilogue.
// bf16: a 128 x 128 tile, 8 warps of 32 x 64, mma.sync m16n8k16 (bf16 in,
// float32 accumulators: bf16 products are exact in float32, so this is the
// TPU's "upcast, then float32 dot" up to the order of summation); x and w
// stream through shared memory in 32-deep k tiles, double-buffered through
// registers, and w's [D, F]-major fragments come transposed by
// ldmatrix.trans.  float32: FMAs on the CUDA cores (TF32 is off by the
// port's rule), a 64 x 64 tile of 4 x 4 outputs a thread; at C <= 128
// (serving's decode and verify steps, bound by the bytes of w) a 16 x 64
// tile whose D loop four thread groups share, their partial sums added in a
// fixed order.  Any C, D and F: edges are checked, and 16-byte loads are
// used where the widths allow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entries,
// bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

struct Params {
  const void* x;
  const void* w;
  const int* gs;
  void* y;
  int C, D, F;
};

// Valid rows of expert e: gs[e] clamped to [0, C].
__device__ __forceinline__ int group_rows(const Params& p, int e) {
  const int g = p.gs[e];
  return g < 0 ? 0 : (g > p.C ? p.C : g);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kLDA = kBK + 8;  // +16 bytes a row: fragment loads hit
constexpr int kLDB = kBN + 8;  // distinct banks; rows stay 16-byte aligned
// elements of a k tile each thread moves: 16 (4096 / 256) of x and of w
constexpr int kPerThread = kBM * kBK / kThreads;
static_assert(kBK * kBN / kThreads == kPerThread, "equal x and w tiles");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) . b (16x8, column-major); bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 tiles of a [k][n] row-major slab: lanes 0-15
// address rows k0..k0+15 at column n0, lanes 16-31 the same rows at
// n0 + 8.  r0, r1 are the m16n8k16 B fragment (b0, b1) of columns
// n0..n0+7, r2, r3 that of n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// One k tile of x (rows [r0, r0 + kBM), columns [k0, k0 + kBK)) and of w
// (rows [k0, k0 + kBK), columns [c0, c0 + kBN)) held in registers between
// the global load and the shared store.  VEC: 8 elements (16 bytes) a
// piece, legal when D and F are multiples of 8 and the bases 16-byte
// aligned; otherwise one element a piece.  Rows of x at or past `rows`
// (the group's padding) and everything past D or F load as zero.
template <bool VEC>
struct TileRegs {
  static constexpr int kPieces = VEC ? kPerThread / 8 : kPerThread;
  static constexpr int kWidth = VEC ? 8 : 1;
  uint4 xv[VEC ? kPieces : 1], wv[VEC ? kPieces : 1];
  __nv_bfloat16 xs[VEC ? 1 : kPieces], ws[VEC ? 1 : kPieces];

  __device__ __forceinline__ void load(const __nv_bfloat16* x,
                                       const __nv_bfloat16* w, int r0,
                                       int rows, int k0, int c0, int D,
                                       int F) {
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int xr = i / (kBK / kWidth), xc = (i % (kBK / kWidth)) * kWidth;
      const int wr = i / (kBN / kWidth), wc = (i % (kBN / kWidth)) * kWidth;
      const bool xok = r0 + xr < rows && k0 + xc < D;
      const bool wok = k0 + wr < D && c0 + wc < F;
      const size_t xo = (size_t)(r0 + xr) * D + k0 + xc;
      const size_t wo = (size_t)(k0 + wr) * F + c0 + wc;
      if constexpr (VEC) {
        xv[j] = xok ? *reinterpret_cast<const uint4*>(x + xo)
                    : make_uint4(0u, 0u, 0u, 0u);
        wv[j] = wok ? *reinterpret_cast<const uint4*>(w + wo)
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        xs[j] = xok ? x[xo] : __float2bfloat16(0.f);
        ws[j] = wok ? w[wo] : __float2bfloat16(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* As,
                                        __nv_bfloat16* Bs) const {
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int xr = i / (kBK / kWidth), xc = (i % (kBK / kWidth)) * kWidth;
      const int wr = i / (kBN / kWidth), wc = (i % (kBN / kWidth)) * kWidth;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(As + xr * kLDA + xc) = xv[j];
        *reinterpret_cast<uint4*>(Bs + wr * kLDB + wc) = wv[j];
      } else {
        As[xr * kLDA + xc] = xs[j];
        Bs[wr * kLDB + wc] = ws[j];
      }
    }
  }
};

// Zeros over the tile's rows [r0, r0 + BM) x columns [c0, c0 + BN) that lie
// inside [C, F].
template <typename T, int BM, int BN, int THREADS>
__device__ __forceinline__ void store_zero_tile(T* y, int r0, int c0, int C,
                                                int F) {
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = r0 + i / BN, c = c0 + i % BN;
    if (r < C && c < F) y[(size_t)r * F + c] = T(0.f);
  }
}

// Warp (wm = warp % 4, wn = warp / 4) owns tile rows 32 wm .. 32 wm + 31 and
// columns 64 wn .. 64 wn + 63: 2 x 8 accumulator tiles of m16n8.  Thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t + 1
// of each.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) gmm_bf16_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kLDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kLDB];

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int rows = group_rows(p, e);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + (size_t)e * p.C * p.F;
  if (r0 >= rows) {  // all padding: the zero store is the whole cost
    store_zero_tile<__nv_bfloat16, kBM, kBN, kThreads>(y, r0, c0, p.C, p.F);
    return;
  }
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(p.x) + (size_t)e * p.C * p.D;
  const __nv_bfloat16* w =
      static_cast<const __nv_bfloat16*>(p.w) + (size_t)e * p.D * p.F;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  TileRegs<VEC> regs;
  const int n_kt = (p.D + kBK - 1) / kBK;
  if (n_kt > 0) {
    regs.load(x, w, r0, rows, 0, c0, p.D, p.F);
    regs.store(As[0], Bs[0]);
  }
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    // the next k tile's global loads are in flight during this tile's mma
    if (kt + 1 < n_kt)
      regs.load(x, w, r0, rows, (kt + 1) * kBK, c0, p.D, p.F);
    const __nv_bfloat16* A = As[cur];
    const __nv_bfloat16* Bm = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* pa =
            A + (wm * 32 + i * 16 + g) * kLDA + kk * 16 + 2 * t;
        a[i][0] = ld32(pa);
        a[i][1] = ld32(pa + 8 * kLDA);
        a[i][2] = ld32(pa + 8);
        a[i][3] = ld32(pa + 8 * kLDA + 8);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b[0], b[1], b[2], b[3],
            Bm + (kk * 16 + (lane & 15)) * kLDB + wn * 64 + jp * 16 +
                (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (kt + 1 < n_kt) regs.store(As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }

  // epilogue: rows of the group keep their sums, padding rows are 0
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * 32 + i * 16 + g + 8 * h;
      if (r >= p.C) continue;
      const bool valid = r < rows;
      __nv_bfloat16* yr = y + (size_t)r * p.F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + wn * 64 + j * 8 + 2 * t;
        const float v0 = valid ? acc[i][j][2 * h] : 0.f;
        const float v1 = valid ? acc[i][j][2 * h + 1] : 0.f;
        if constexpr (VEC) {
          if (c < p.F)  // F % 8 == 0: the pair is whole and 4-byte aligned
            *reinterpret_cast<uint32_t*>(yr + c) = pack_bf16(v0, v1);
        } else {
          if (c < p.F) yr[c] = __float2bfloat16(v0);
          if (c + 1 < p.F) yr[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFThreads = (kFBM / 4) * (kFBN / 4);

// Thread (tx = tid % 16, ty = tid / 16) owns tile rows 4 ty .. 4 ty + 3 and
// columns 4 tx .. 4 tx + 3.  x's k tile is stored k-major so a thread's four
// rows are one 16-byte shared load.
__global__ void __launch_bounds__(kFThreads) gmm_f32_kernel(Params p) {
  constexpr int BM = kFBM, kT = kFThreads;
  __shared__ __align__(16) float As[kFBK][BM + 4];
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kFBN;
  const int rows = group_rows(p, e);
  float* y = static_cast<float*>(p.y) + (size_t)e * p.C * p.F;
  if (r0 >= rows) {
    store_zero_tile<float, BM, kFBN, kT>(y, r0, c0, p.C, p.F);
    return;
  }
  const float* x = static_cast<const float*>(p.x) + (size_t)e * p.C * p.D;
  const float* w = static_cast<const float*>(p.w) + (size_t)e * p.D * p.F;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += kFBK) {
    for (int i = threadIdx.x; i < BM * kFBK; i += kT) {
      const int r = i / kFBK, k = i % kFBK;
      As[k][r] = (r0 + r < rows && k0 + k < p.D)
                     ? x[(size_t)(r0 + r) * p.D + k0 + k]
                     : 0.f;
    }
    for (int i = threadIdx.x; i < kFBK * kFBN; i += kT) {
      const int k = i / kFBN, c = i % kFBN;
      Bs[k][c] = (k0 + k < p.D && c0 + c < p.F)
                     ? w[(size_t)(k0 + k) * p.F + c0 + c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= p.C) continue;
    const bool valid = r < rows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < p.F) y[(size_t)r * p.F + c] = valid ? acc[i][j] : 0.f;
    }
  }
}

// float32 with few rows a group (decode and verify steps, C <= 128): the
// bytes of w bound it, and a 64 x 64 tile of 256 threads leaves too few
// loads in flight.  A 16-row tile of 64 columns instead, its D loop split
// over kKS groups of 64 threads, group j taking k tiles j, j + kKS, ...,
// each synchronising on its own named barrier; w comes in 16-byte loads
// where F is a multiple of 4.  The groups' partial sums are added in shared
// memory in a fixed order, so two runs still give the same bits.
constexpr int kSBM = 16, kSBN = 64, kSBK = 32, kKS = 4;
constexpr int kSThreads = 64 * kKS;
constexpr int kSmallC = 128;  // C at or below this takes this kernel

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(group + 1));
}

template <bool VEC>
__global__ void __launch_bounds__(kSThreads) gmm_f32_small_kernel(Params p) {
  __shared__ __align__(16) float As[kKS][kSBK][kSBM + 4];
  __shared__ __align__(16) float Bs[kKS][kSBK][kSBN + 4];
  static_assert(kKS * kSBM * (kSBN + 4) <= kKS * kSBK * (kSBN + 4),
                "the partial sums fit where the w tiles were");

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kSBM, c0 = blockIdx.x * kSBN;
  const int rows = group_rows(p, e);
  float* y = static_cast<float*>(p.y) + (size_t)e * p.C * p.F;
  if (r0 >= rows) {
    store_zero_tile<float, kSBM, kSBN, kSThreads>(y, r0, c0, p.C, p.F);
    return;
  }
  const float* x = static_cast<const float*>(p.x) + (size_t)e * p.C * p.D;
  const float* w = static_cast<const float*>(p.w) + (size_t)e * p.D * p.F;
  const int grp = threadIdx.x >> 6, lt = threadIdx.x & 63;
  const int tx = lt & 15, ty = lt >> 4;  // columns 4 tx.., rows 4 ty..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_kt = (p.D + kSBK - 1) / kSBK;
  for (int kt = grp; kt < n_kt; kt += kKS) {
    const int k0 = kt * kSBK;
#pragma unroll
    for (int i = lt; i < kSBM * kSBK; i += 64) {
      const int r = i / kSBK, k = i % kSBK;
      As[grp][k][r] = (r0 + r < rows && k0 + k < p.D)
                          ? x[(size_t)(r0 + r) * p.D + k0 + k]
                          : 0.f;
    }
    if constexpr (VEC) {
#pragma unroll
      for (int i = lt; i < kSBK * kSBN / 4; i += 64) {
        const int k = i / (kSBN / 4), c = (i % (kSBN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < p.D && c0 + c < p.F)
          v = *reinterpret_cast<const float4*>(w + (size_t)(k0 + k) * p.F +
                                               c0 + c);
        *reinterpret_cast<float4*>(&Bs[grp][k][c]) = v;
      }
    } else {
      for (int i = lt; i < kSBK * kSBN; i += 64) {
        const int k = i / kSBN, c = i % kSBN;
        Bs[grp][k][c] = (k0 + k < p.D && c0 + c < p.F)
                            ? w[(size_t)(k0 + k) * p.F + c0 + c]
                            : 0.f;
      }
    }
    group_sync(grp);
#pragma unroll 8
    for (int k = 0; k < kSBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[grp][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[grp][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    group_sync(grp);  // this group's tiles are consumed
  }

  // partial sums of the kKS groups, added in group order
  __syncthreads();  // every group is done with its w tiles
  float* red = &Bs[0][0][0];  // [kKS][kSBM][kSBN + 4]
  constexpr int kLD = kSBN + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(grp * kSBM + ty * 4 + i) * kLD + tx * 4 + j] = acc[i][j];
  __syncthreads();
  for (int o = threadIdx.x; o < kSBM * kSBN; o += kSThreads) {
    const int r = o / kSBN, c = o % kSBN;
    if (r0 + r >= p.C || c0 + c >= p.F) continue;
    float v = red[r * kLD + c];
#pragma unroll
    for (int g = 1; g < kKS; ++g) v += red[(g * kSBM + r) * kLD + c];
    y[(size_t)(r0 + r) * p.F + c0 + c] = r0 + r < rows ? v : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: a persistent walk over the tiles, a TMA ring, wgmma
// ---------------------------------------------------------------------------
constexpr int kWM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int kWN = 128;  // columns a tile: two 64-column atoms of w
constexpr int kWK = 64;   // k a stage: one 128-byte swizzle atom of x
constexpr int kWStages = 5;

struct WParams {
  const int* gs;
  __nv_bfloat16* y;
  int E, C, D, F, tiles_m, tiles_n;
};

__device__ __forceinline__ int wgroup_rows(const WParams& p, int e) {
  const int g = p.gs[e];
  return g < 0 ? 0 : (g > p.C ? p.C : g);
}

// Row tiles of expert e that hold a valid row.
__device__ __forceinline__ int valid_row_tiles(const WParams& p, int e) {
  return (wgroup_rows(p, e) + kWM - 1) / kWM;
}

// The tiles of the walk in order: index i < n_valid is a tile with valid
// rows (expert by expert, then row tile, then column tile), the rest are
// tiles wholly past their group.  A block visits increasing i, so the
// expert cursor only moves forward.
struct TileWalk {
  int e = 0, base = 0;
  __device__ __forceinline__ void valid(const WParams& p, int i, int& ex,
                                        int& mt, int& nt) {
    const int u = i / p.tiles_n;
    nt = i - u * p.tiles_n;
    for (int v = valid_row_tiles(p, e); u >= base + v;
         v = valid_row_tiles(p, e)) {
      base += v;
      ++e;
    }
    ex = e;
    mt = u - base;
  }
  __device__ __forceinline__ void past(const WParams& p, int z, int& ex,
                                       int& mt, int& nt) {
    const int u = z / p.tiles_n;
    nt = z - u * p.tiles_n;
    for (int v = p.tiles_m - valid_row_tiles(p, e); u >= base + v;
         v = p.tiles_m - valid_row_tiles(p, e)) {
      base += v;
      ++e;
    }
    ex = e;
    mt = valid_row_tiles(p, e) + u - base;
  }
};

// Shared memory (1024-byte aligned, the swizzle's period): kWStages stages
// of x [128 rows][64 k] (one atom) and w [2 atoms][64 k][64 columns], each
// consumer warpgroup's output staging [2 atoms][64 rows][64 columns]
// (swizzled as TMA stores it), then the barriers.  Warps 0-7 are two
// consumer warpgroups of 64 rows; warpgroup 2 is the producer.  A consumer
// thread (g = lane / 4, t = lane % 4) of warp w holds rows 16 w + g and + 8,
// columns 8 j + 2 t, + 1 of its m64n128 accumulator.
constexpr int kWXBytes = kWM * kWK * 2;
constexpr int kWStage = kWXBytes + kWK * kWN * 2;
constexpr int kWYBytes = 64 * kWN * 2;  // a warpgroup's staged output
constexpr int kWSmem = 1024 + kWStages * kWStage + 2 * kWYBytes +
                       2 * kWStages * 8;

__global__ void __launch_bounds__(sm90::kThreadsWg, 1)
gmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap ty, WParams p) {
  constexpr int BN = kWN, ST = kWStages, STAGE = kWStage;
  constexpr int X_BYTES = kWXBytes, Y_BYTES = kWYBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = sm90::smem_1024(smem_raw);
  unsigned char* stage_out = ring + ST * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + 2 * Y_BYTES);
  uint64_t* empty = full + ST;

  int vt = 0;
  for (int e = 0; e < p.E; ++e) vt += valid_row_tiles(p, e);
  const int n_valid = vt * p.tiles_n;
  const int n_tiles = p.E * p.tiles_m * p.tiles_n;
  const int n_kt = (p.D + kWK - 1) / kWK;
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
      TileWalk walk;
      int it = 0;  // stages filled so far, across tiles
      for (int i = blockIdx.x; i < n_valid; i += gridDim.x) {
        int e, mt, nt;
        walk.valid(p, i, e, mt, nt);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int st = it % ST;
          if (it >= ST) sm90::mbar_wait(&empty[st], (it / ST - 1) & 1);
          sm90::mbar_expect_tx(&full[st], STAGE);
          unsigned char* xs = ring + st * STAGE;
          sm90::tma_load(xs, &tx, &full[st], kt * kWK, mt * kWM, e);
#pragma unroll
          for (int a = 0; a < BN / 64; ++a)
            sm90::tma_load(xs + X_BYTES + a * kWK * 128, &tw, &full[st],
                           nt * BN + 64 * a, kt * kWK, e);
        }
      }
    }
    return;
  }
  sm90::consumer_regs();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  TileWalk walk, past;
  int it = 0;  // stages consumed so far, across tiles
  float acc[BN / 2];
  int i = blockIdx.x;
  for (; i < n_valid; i += gridDim.x) {
    int e, mt, nt;
    walk.valid(p, i, e, mt, nt);
#pragma unroll
    for (int v = 0; v < BN / 2; ++v) acc[v] = 0.f;
    // each stage's four k16 products are committed as one group; the
    // stage before is released once at most that group is in flight
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int st = it % ST;
      sm90::mbar_wait(&full[st], (it / ST) & 1);
      const unsigned char* xs = ring + st * STAGE + wg * 64 * 128;
      const unsigned char* ws = ring + st * STAGE + X_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        sm90::wgmma_ss_tb_n128(acc, sm90::sw128_desc(xs + kk * 32, 16, 1024),
                               sm90::sw128_desc(ws + kk * 2048, kWK * 128,
                                                1024),
                               1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (kt > 0) sm90::mbar_arrive(&empty[(it - 1) % ST]);
    }
    sm90::wgmma_wait<0>();
    sm90::reg_fence(acc);
    if (n_kt > 0) sm90::mbar_arrive(&empty[(it - 1) % ST]);

    // epilogue: valid rows rounded to bf16 once, padding rows 0, staged
    // in shared memory and stored by TMA (rows past C and columns past F
    // are clipped); the warpgroup's next tile starts while the store runs
    const int rows = wgroup_rows(p, e);
    unsigned char* out = stage_out + wg * Y_BYTES;
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // out is free
    sm90::named_sync(1 + wg, 128);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int rl = warp * 16 + g + 8 * rr;  // row in the warpgroup's 64
      const bool ok = mt * kWM + wg * 64 + rl < rows;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        *reinterpret_cast<uint32_t*>(
            out + (n >> 3) * 64 * 128 + rl * 128 +
            (((n & 7) ^ (rl & 7)) << 4) + 4 * t) =
            ok ? sm90::pack_bf16(acc[4 * n + 2 * rr], acc[4 * n + 2 * rr + 1])
               : 0u;
    }
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int a = 0; a < BN / 64; ++a)
        sm90::tma_store(&ty, out + a * 64 * 128, nt * BN + 64 * a,
                        mt * kWM + wg * 64, e);
      sm90::bulk_commit();
    }
  }
  // then the tiles wholly past their group: zeros, 16 bytes a store
  for (; i < n_tiles; i += gridDim.x) {
    int e, mt, nt;
    past.past(p, i - n_valid, e, mt, nt);
    __nv_bfloat16* y = p.y + (size_t)e * p.C * p.F + nt * BN;
    const int chunks = min(BN, p.F - nt * BN) / 8;  // 8 columns a chunk
    for (int o = threadIdx.x; o < kWM * (BN / 8); o += sm90::kConsumers) {
      const int r = mt * kWM + o / (BN / 8), c = o % (BN / 8);
      if (r < p.C && c < chunks)
        *reinterpret_cast<uint4*>(y + (size_t)r * p.F + 8 * c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the last stores
}

cudaError_t launch_wgmma(const void* x, const void* w, const int* gs,
                         void* y, int E, int C, int D, int F,
                         cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  cudaError_t e = sm90::tensor_map(&tx, x, E, C, D, kWM);
  if (e == cudaSuccess) e = sm90::tensor_map(&tw, w, E, D, F, kWK);
  if (e == cudaSuccess) e = sm90::tensor_map(&ty, y, E, C, F, 64);
  if (e != cudaSuccess) return e;
  // per device, on its first call: the SM count, and the kernel's shared
  // memory allowed (outside any CUDA graph capture)
  static int sms_of[64] = {0};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gmm_bf16_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWSmem);
    if (e != cudaSuccess) {
      sms_of[dev] = 0;
      return e;
    }
  }
  const WParams p{gs, static_cast<__nv_bfloat16*>(y), E, C, D, F,
                  (C + kWM - 1) / kWM, (F + kWN - 1) / kWN};
  const long long tiles = (long long)E * p.tiles_m * p.tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms_of[dev] ? tiles : sms_of[dev]);
  gmm_bf16_wgmma_kernel<<<grid, sm90::kThreadsWg, kWSmem, stream>>>(tx, tw,
                                                                     ty, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  Layouts (all
// contiguous): x [E, C, D], w [E, D, F], y [E, C, F], gs [E] int32 (any
// value; clamped to [0, C]).  E, C, F >= 1, D >= 0; C / 16 and E must fit
// a grid dimension (65535).  Launches on `stream`, does not synchronise,
// returns the launch's cudaError_t.
extern "C" int grouped_matmul(int dtype, const void* x, const void* w,
                              const void* gs, void* y, int E, int C, int D,
                              int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D < 0 || F <= 0 || E > 65535)
    return cudaErrorInvalidValue;
  const Params p{x, w, static_cast<const int*>(gs), y, C, D, F};
  if (dtype == 1) {
    const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16(x) &&
                     aligned16(w) && aligned16(y);
    if (vec)
      gmm_bf16_kernel<true><<<grid, kThreads, 0, st>>>(p);
    else
      gmm_bf16_kernel<false><<<grid, kThreads, 0, st>>>(p);
  } else if (dtype == 0) {
    if (C <= kSmallC) {
      const dim3 grid((F + kSBN - 1) / kSBN, (C + kSBM - 1) / kSBM, E);
      if (F % 4 == 0 && aligned16(w))
        gmm_f32_small_kernel<true><<<grid, kSThreads, 0, st>>>(p);
      else
        gmm_f32_small_kernel<false><<<grid, kSThreads, 0, st>>>(p);
    } else {
      const dim3 grid((F + kFBN - 1) / kFBN, (C + kFBM - 1) / kFBM, E);
      if (grid.y > 65535) return cudaErrorInvalidValue;
      gmm_f32_kernel<<<grid, kFThreads, 0, st>>>(p);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 on the TMA ring and wgmma.  Layouts as grouped_matmul's (bfloat16
// only).  It takes D and F multiples of 8 (D >= 8) and 16-byte-aligned x,
// w, y, what TMA needs (grouped_matmul.py's choice); anything else returns
// cudaErrorInvalidValue.
extern "C" int grouped_matmul_wgmma(const void* x, const void* w,
                                    const void* gs, void* y, int E, int C,
                                    int D, int F, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D < 8 || D % 8 != 0 || F < 8 ||
      F % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  return launch_wgmma(x, w, static_cast<const int*>(gs), y, E, C, D, F,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* grouped_matmul_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
