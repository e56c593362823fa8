// Quantized matmul with a fused dequantize + bias epilogue for Hopper
// (sm_90a): out[M, N] = float(xq[M, K] @ wq[K, N]) * scale[N] + bias[N].
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/quantized_matmul.py
// (_kernel / _qmm_pallas, reached through quantized_linear).  It computes
// the same function, not a block-by-block copy:
//   int8:  int8 x int8 products summed exactly in int32, then converted to
//          float32 (round to nearest even);
//   fp8:   e4m3 operands converted to float32 (cuda_fp8.h), products summed
//          in float32 along K in order;
//   both:  out = acc * scale[n] + bias[n] in float32, multiply then add with
//          separate roundings (no fused multiply-add), which is what the
//          plain PyTorch version does, so the int8 leg agrees with it bit
//          for bit.
// Any M, K, N: the TPU's 32/128 tile rules do not carry over; ragged edges
// are masked here (zero operands past K, no stores past M or N).
//
// What bounds it on an H100: bytes.  On the serving path M is 8 (decode),
// 40 (1 + k verify) or up to 384 (admission) while the weight is 0.6-2.4
// MB, so the work is one pass over the weight: (M*K + K*N) + 8*N + 4*M*N
// bytes, under a microsecond at 3.35 TB/s.  At that size a launch is
// latency-bound, not bandwidth-bound.
//
// What this first design does about it: the weight is read once per M
// tile, in 32-column strips, each strip by one 128-thread block that walks
// K in tiles staged through shared memory; the next tile's global loads
// are started into registers before the current tile's math, so the two
// overlap.  The weight is [K, N] row-major, so the four K-neighbours that
// one __dp4a wants sit N bytes apart: each thread loads a 4 x 4 byte patch
// (four rows, four columns), transposes it with __byte_perm and stores
// words that hold four consecutive K for one column.  Blocks take 16 rows
// when M <= 64 (more blocks for the small-M decode shapes), 64 rows
// otherwise.  Not done yet (later work): split-K for the small-M shapes
// (24-96 blocks on 132 SMs), cp.async/TMA staging, tensor-core mma/wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 32;             // output columns per block
constexpr int kKW = 32;             // shared-memory words along K per tile
constexpr int kXStride = kKW + 1;   // padded: rows of one warp hit distinct banks
constexpr int kTx = kBN / 4;        // threads across the columns (4 each)
constexpr int kTy = kThreads / kTx; // threads down the rows (TM each)

__device__ __forceinline__ float e4m3_to_f32(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte & 0xffu);
  return static_cast<float>(v);
}

// Four consecutive bytes of row `row` of a row-major [rows, cols] byte
// matrix starting at column `col`, as one little-endian word; bytes past
// the matrix read as 0.  `vec`: cols % 4 == 0 and the base is 4-byte
// aligned, so (with col % 4 == 0) one 32-bit load is legal.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ base,
                                          int row, int col, int rows,
                                          int cols, bool vec) {
  if (row >= rows || col >= cols) return 0u;
  const uint8_t* p = base + (size_t)row * cols + col;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < cols) r |= (uint32_t)p[j] << (8 * j);
  return r;
}

// FP8 = false: int8 operands, one shared word = 4 consecutive K, __dp4a.
// FP8 = true:  e4m3 operands, one shared word = one float32, fmaf.
// TM: output rows per thread; the block covers 16 * TM rows x 32 columns.
template <bool FP8, int TM>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           float* __restrict__ out, int M, int K, int N, bool xvec,
           bool wvec) {
  constexpr int BM = kTy * TM;
  constexpr int KPW = FP8 ? 1 : 4;           // K elements per shared word
  constexpr int BK = kKW * KPW;              // K elements per tile
  constexpr int XWPR = BK / 4;               // 4-byte x loads per tile row
  constexpr int XU = BM * XWPR / kThreads;   // x loads per thread per tile
  constexpr int WU = kKW * kTx / kThreads;   // w patches per thread per tile
  constexpr int WL = FP8 ? 1 : 4;            // rows per w patch
  static_assert(BM * XWPR % kThreads == 0 && kKW * kTx % kThreads == 0, "");

  __shared__ uint32_t x_s[BM * kXStride];
  __shared__ __align__(16) uint32_t w_s[kKW * kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;

  int acc_i[TM][4];
  float acc_f[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_i[i][j] = 0;
      acc_f[i][j] = 0.f;
    }

  uint32_t xr[XU], wr[WU * WL];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int id = tid + u * kThreads;
      const int m = id / XWPR, c = id % XWPR;
      xr[u] = load4(x, m0 + m, k0 + 4 * c, M, K, xvec);
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int id = tid + u * kThreads;
      const int kw = id / kTx, n4 = id % kTx;
#pragma unroll
      for (int r = 0; r < WL; ++r)
        wr[u * WL + r] = load4(w, k0 + kw * KPW + r, n0 + 4 * n4, K, N, wvec);
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int id = tid + u * kThreads;
      const int m = id / XWPR, c = id % XWPR;
      if constexpr (FP8) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x_s[m * kXStride + 4 * c + j] =
              __float_as_uint(e4m3_to_f32(xr[u] >> (8 * j)));
      } else {
        x_s[m * kXStride + c] = xr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int id = tid + u * kThreads;
      const int kw = id / kTx, n4 = id % kTx;
      uint4 o;
      if constexpr (FP8) {
        const uint32_t r0 = wr[u];
        o.x = __float_as_uint(e4m3_to_f32(r0));
        o.y = __float_as_uint(e4m3_to_f32(r0 >> 8));
        o.z = __float_as_uint(e4m3_to_f32(r0 >> 16));
        o.w = __float_as_uint(e4m3_to_f32(r0 >> 24));
      } else {
        // rows k..k+3 x columns n..n+3 -> per column, the four K bytes
        const uint32_t r0 = wr[u * WL], r1 = wr[u * WL + 1],
                       r2 = wr[u * WL + 2], r3 = wr[u * WL + 3];
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
        const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
        const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
        o.x = __byte_perm(t0, t1, 0x5410);
        o.y = __byte_perm(t0, t1, 0x7632);
        o.z = __byte_perm(t2, t3, 0x5410);
        o.w = __byte_perm(t2, t3, 0x7632);
      }
      *reinterpret_cast<uint4*>(&w_s[kw * kBN + 4 * n4]) = o;
    }
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    stage();
    __syncthreads();
    if (kt + 1 < nk) fetch((kt + 1) * BK);  // in flight during the math
#pragma unroll 8
    for (int kw = 0; kw < kKW; ++kw) {
      const uint4 wv = *reinterpret_cast<const uint4*>(&w_s[kw * kBN + 4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint32_t xv = x_s[(ty * TM + i) * kXStride + kw];
        if constexpr (FP8) {
          const float xf = __uint_as_float(xv);
          acc_f[i][0] = fmaf(xf, __uint_as_float(wv.x), acc_f[i][0]);
          acc_f[i][1] = fmaf(xf, __uint_as_float(wv.y), acc_f[i][1]);
          acc_f[i][2] = fmaf(xf, __uint_as_float(wv.z), acc_f[i][2]);
          acc_f[i][3] = fmaf(xf, __uint_as_float(wv.w), acc_f[i][3]);
        } else {
          acc_i[i][0] = __dp4a((int)xv, (int)wv.x, acc_i[i][0]);
          acc_i[i][1] = __dp4a((int)xv, (int)wv.y, acc_i[i][1]);
          acc_i[i][2] = __dp4a((int)xv, (int)wv.z, acc_i[i][2]);
          acc_i[i][3] = __dp4a((int)xv, (int)wv.w, acc_i[i][3]);
        }
      }
    }
    __syncthreads();  // tile fully consumed before the next stage()
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      const float a = FP8 ? acc_f[i][j] : (float)acc_i[i][j];
      out[(size_t)m * N + n] = __fadd_rn(__fmul_rn(a, scale[n]), bias[n]);
    }
  }
}

template <bool FP8, int TM>
cudaError_t launch(const uint8_t* x, const uint8_t* w, const float* scale,
                   const float* bias, float* out, int M, int K, int N,
                   cudaStream_t stream) {
  const int BM = kTy * TM;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  qmm_kernel<FP8, TM><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out,
                                                     M, K, N, xvec, wvec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = int8 (int32 accumulate), 1 = float8_e4m3fn (float32
// accumulate); xq and wq share it.  Layouts (all contiguous): xq [M, K],
// wq [K, N], scale / bias [N] float32, out [M, N] float32; M, N >= 1,
// K >= 0.  Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int quantized_matmul(int dtype, const void* xq, const void* wq,
                                const void* scale, const void* bias,
                                void* out, int M, int K, int N,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  const bool small = M <= 64;  // 16-row blocks: more blocks in flight
  if (dtype == 0)
    return small ? launch<false, 1>(x, w, sc, bi, o, M, K, N, s)
                 : launch<false, 4>(x, w, sc, bi, o, M, K, N, s);
  if (dtype == 1)
    return small ? launch<true, 1>(x, w, sc, bi, o, M, K, N, s)
                 : launch<true, 4>(x, w, sc, bi, o, M, K, N, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* quantized_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
