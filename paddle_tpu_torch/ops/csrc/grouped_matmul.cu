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
// ridge.  At decode (C = 16, f32) the weights dominate and it is bytes.
//
// What this first design does about it: one block per (output tile,
// expert).  A block reads gs[e]; a tile whose first row is at or past it
// stores zeros and does no product, so padding rows cost only their zero
// store (the point of the TPU kernel, which masks them in VMEM).  Rows of
// the padding inside a partial tile are loaded as zeros and stored as
// zeros in the epilogue.  bf16: a 128 x 128 tile, 8 warps of 32 x 64,
// mma.sync m16n8k16 (bf16 in, float32 accumulators: bf16 products are
// exact in float32, so this is the TPU's "upcast, then float32 dot" up to
// the order of summation); x and w stream through shared memory in
// 32-deep k tiles, double-buffered through registers, and w's [D, F]-major
// fragments come transposed by ldmatrix.trans.  float32: FMAs on the CUDA
// cores (TF32 is off by the port's rule), a 64 x 64 tile of 4 x 4 outputs
// a thread; at C <= 128 (serving's decode and verify steps, bound by the
// bytes of w) a 16 x 64 tile whose D loop four thread groups share, their
// partial sums added in a fixed order.  Any C, D and F: edges are checked,
// and 16-byte loads are used where the widths allow.  No split-K across
// blocks and no atomics: two runs give the same bits.  Not done yet (later
// work):
// cp.async / TMA with an mbarrier pipeline, wgmma, a persistent schedule
// over the valid tiles only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
