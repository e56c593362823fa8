// Fused residual add + LayerNorm forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/fused_layernorm.py
// (_kernel / _ln_res_pallas, public entry layernorm_residual).  It computes
// the same function, row by row over x, r [M, D]:
//   s    = round_to_T(f32(x) + f32(r))        the residual stream, in T
//   mean = sum(f32(s)) / D;  c = f32(s) - mean
//   var  = sum(c * c) / D                     two passes over registers,
//                                             not E[s^2] - mean^2
//   rstd = 1 / sqrt(var + eps)
//   y    = round_to_T(c * rstd * g + b)
// and writes mean and rstd as f32 [M] for the backward.  The ROUNDED sum is
// normalized, as the TPU kernel does: that is what an unfused x + r then
// LayerNorm sees.
//
// What bounds it on an H100: bytes.  Each row reads x and r and writes s and
// y once (4 * D * itemsize bytes) plus 8 bytes of statistics, for a handful
// of flops per element, far below the card's flop/byte ridge.  BERT-base
// pretraining's [32768, 768] bf16 call moves 201.6 MB: ~60 us at 3.35 TB/s.
//
// What this first design does about it: for D <= 768, one warp per row,
// the row held in registers (D <= 32 * VPT, VPT values per lane), so x and
// r are read once and s and y written once; the sum and the centred sum of
// squares are warp shuffles, with no shared memory and no barrier.  Four
// rows per 128-thread block.  Wider rows take the wide variant below: one
// block per row, the row in shared memory.  Neighbouring lanes touch
// neighbouring elements, so every load and store is coalesced.  Not done
// yet (later work): 16-byte vector loads and several rows per warp for
// small D.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
ln_res_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ g, const T* __restrict__ b,
              T* __restrict__ s, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const size_t base = (size_t)row * D;

  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = lane + 32 * i;
    v[i] = 0.f;
    if (d < D) {
      const T so = from_f32<T>(to_f32(x[base + d]) + to_f32(r[base + d]));
      s[base + d] = so;
      v[i] = to_f32(so);
      sum += v[i];
    }
  }
  const float mean = warp_sum(sum) / (float)D;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + 32 * i < D) {
      v[i] -= mean;
      sq += v[i] * v[i];
    }
  }
  const float var = warp_sum(sq) / (float)D;
  const float rstd = 1.f / sqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      const float yn = v[i] * rstd;
      y[base + d] = from_f32<T>(yn * to_f32(g[d]) + to_f32(b[d]));
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int VPT>
cudaError_t launch(const void* x, const void* r, const void* g, const void* b,
                   void* s, void* y, float* mean, float* rstd, int M, int D,
                   float eps, cudaStream_t stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  ln_res_kernel<T, VPT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(s),
      static_cast<T*>(y), mean, rstd, M, D, eps);
  return cudaGetLastError();
}

// Registers per lane: 24 values cover D <= 768 (BERT-base, GPT-small).
constexpr int kVPT = 24;
constexpr int kMaxD = 32 * kVPT;

// The wide variant, D > 768 (BERT-large, GPT-medium and wider): one block
// of kWideThreads per row, the row's rounded sum staged in shared memory
// as float32 (4 * D bytes), so x and r are still read once and s and y
// written once; the same two-pass float32 statistics, each a block
// reduction (warp shuffles, then the warps' partials added in one fixed
// order by every thread).
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxWideD = 49152;  // 192 KB of shared memory a row

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) t += red[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
ln_res_wide_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ g, const T* __restrict__ b,
                   T* __restrict__ s, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int D, float eps) {
  extern __shared__ float row[];  // [D]: the rounded sum, then centred
  __shared__ float red[kWideWarps];
  const size_t base = (size_t)blockIdx.x * D;

  float sum = 0.f;
  for (int d = threadIdx.x; d < D; d += kWideThreads) {
    const T so = from_f32<T>(to_f32(x[base + d]) + to_f32(r[base + d]));
    s[base + d] = so;
    row[d] = to_f32(so);
    sum += row[d];
  }
  const float mean = block_sum(sum, red) / (float)D;

  float sq = 0.f;
  for (int d = threadIdx.x; d < D; d += kWideThreads) {
    const float c = row[d] - mean;
    row[d] = c;
    sq += c * c;
  }
  const float var = block_sum(sq, red) / (float)D;
  const float rstd = 1.f / sqrtf(var + eps);

  for (int d = threadIdx.x; d < D; d += kWideThreads) {
    const float yn = row[d] * rstd;
    y[base + d] = from_f32<T>(yn * to_f32(g[d]) + to_f32(b[d]));
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T>
cudaError_t launch_wide(const void* x, const void* r, const void* g,
                        const void* b, void* s, void* y, float* mean,
                        float* rstd, int M, int D, float eps,
                        cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_res_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_res_wide_kernel<T><<<M, kWideThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(s),
      static_cast<T*>(y), mean, rstd, D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, g, b, s and y share it).
// Layouts (all contiguous): x, r, s, y [M, D]; g, b [D]; mean, rstd [M] f32.
// 1 <= D <= 768.  Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t.
extern "C" int layernorm_residual_fwd(int dtype, const void* x, const void* r,
                                      const void* g, const void* b, void* s,
                                      void* y, void* mean, void* rstd, int M,
                                      int D, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (M <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, kVPT>(x, r, g, b, s, y, mu, rs, M, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kVPT>(x, r, g, b, s, y, mu, rs, M, D, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* layernorm_residual_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The wide variant: as layernorm_residual_fwd, for 768 < D <= 49152.
extern "C" int layernorm_residual_fwd_wide(int dtype, const void* x,
                                           const void* r, const void* g,
                                           const void* b, void* s, void* y,
                                           void* mean, void* rstd, int M,
                                           int D, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (M <= 0 || D <= kMaxD || D > kMaxWideD) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_wide<float>(x, r, g, b, s, y, mu, rs, M, D, eps, st);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(x, r, g, b, s, y, mu, rs, M, D, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* layernorm_residual_fwd_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
