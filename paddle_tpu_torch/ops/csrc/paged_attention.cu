// Paged flash-decode attention for Hopper (sm_90a): the page-table walk
// happens inside the kernel.
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/paged_attention.py
// (_kernel / _paged_decode, public entry paged_flash_decode), float pools
// and the quantized (int8 / fp8-e4m3) pools with their scale planes.
// It computes the same function, not a block-by-block copy:
//   for each (b, h, t):  s_j = (q . k_j) * (1/sqrt(hd)) over the G*page keys
//   of slot b, key j living on page tables[b, j / page] at offset j % page;
//   masked keys are filled with -1e30; p = exp(s - m) * mask, so a masked key
//   contributes exactly 0 even before any valid key was seen; f32
//   accumulation; out = l > 0 ? acc / l : 0, written in q's dtype.
//   Quantized pools: key j of page p, head h is k_pool[p, h, j, :] as float32
//   times k_scale[p, h, j] (v likewise), multiplied as the page is staged
//   into shared memory, so a float K/V view never exists in device memory.
//
// What bounds it on an H100: bytes.  Each (b, h) reads its slot's K and V
// pages once (page * hd elements each, per page; one byte an element plus
// 4 bytes a key of scale for a quantized pool), a few flops per byte, far
// below the ~295 flop/byte ridge of the card; at decode T = 1 the work is a
// pure stream of the KV pages.
//
// What this first design does about it: one block per (b, h, 16-row T tile)
// streams each page of K and V from the pool straight into shared memory
// exactly once and serves every query row of the tile from there, so a
// T = 1 + k verify step or a prompt-bucket admission reads the KV once per
// tile, not once per row; the [B, H, G*page, hd] gathered view the plain
// version builds never exists.  A page whose K and V do not fit in shared
// memory beside the q tile (page 1024 at hd 64) is staged in chunks of
// rows, the online softmax running on across them; that path and head_dim
// 257-512 share one instance per dtype pair.  Shared rows are padded to
// hd + 1 floats so the lane-per-key dot products hit distinct banks.  Not
// done yet (later work): overlapping the next page's load with this page's math
// (cp.async / TMA double buffering), splitting long caches across blocks
// for small B*H, skipping pages whose mask is all zero, wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 16;                    // query rows per T tile
constexpr int kRowsPerWarp = kRowsPerBlock / kWarps;
constexpr float kNeg = -1e30f;                       // mask fill, as the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// NC: 32-wide chunks of head_dim each lane accumulates (hd <= 32 * NC).
// Warp w owns tile rows w, w + 4, w + 8, w + 12, so a T = 1 + k verify tile
// spreads over all four warps.  Per page and per 32-key chunk, lane j scores
// key j; the online-softmax update then broadcasts each p_j with a shuffle
// while lanes own the head_dim columns of the accumulator.
// chunk: rows of a page staged at once (the whole page when it fits).
// T: q / out element type; KV: pool element type — T itself, or a one-byte
// quantized type (int8_t, __nv_fp8_e4m3), whose rows are multiplied by
// k_scale / v_scale [P1, H, page] while they are staged.
template <typename T, typename KV, int NC, bool kChunked>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int H, int Tq, int hd, int page, int chunk, int G,
                    int P1, float sm_scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  extern __shared__ float smem[];
  const int ks = hd + 1;
  float* k_s = smem;              // [chunk, hd + 1]
  float* v_s = k_s + chunk * ks;  // [chunk, hd + 1]
  float* q_s = v_s + chunk * ks;  // [kRowsPerBlock, hd]

  const int b = blockIdx.z, h = blockIdx.y;
  const int t0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t C = (size_t)G * page;
  const size_t bh = (size_t)b * H + h;

  for (int i = threadIdx.x; i < kRowsPerBlock * hd; i += kThreads) {
    const int r = i / hd, t = t0 + r;
    q_s[i] = t < Tq ? to_f32(q[(bh * Tq + t) * hd + (i - r * hd)]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  const size_t page_elems = (size_t)page * hd;
  // one step per staged piece: a whole page (kChunked false: chunk ==
  // page, and the piece arithmetic folds away), else `chunk` rows of it
  const int per_page = kChunked ? (page + chunk - 1) / chunk : 1;
  for (int it = 0; it < G * per_page; ++it) {
    const int g = kChunked ? it / per_page : it;
    const int c0 = kChunked ? (it - g * per_page) * chunk : 0;
    const int rows = kChunked ? min(chunk, page - c0) : page;
    // unmapped entries arrive clipped to a valid page and fully masked;
    // clamp anyway so a bad table can never read outside the pool
    const int p = min(max(tables[(size_t)b * G + g], 0), P1 - 1);
    const KV* kp = k_pool + ((size_t)p * H + h) * page_elems + (size_t)c0 * hd;
    const KV* vp = v_pool + ((size_t)p * H + h) * page_elems + (size_t)c0 * hd;
    const size_t srow = ((size_t)p * H + h) * page + c0;  // scale row
    __syncthreads();  // previous piece fully consumed (and q_s staged)
    for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      if constexpr (kQuant) {
        k_s[j * ks + d] = to_f32(kp[i]) * k_scale[srow + j];
        v_s[j * ks + d] = to_f32(vp[i]) * v_scale[srow + j];
      } else {
        k_s[j * ks + d] = to_f32(kp[i]);
        v_s[j * ks + d] = to_f32(vp[i]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      const int t = t0 + r;
      if (t >= Tq) continue;  // warp-uniform: r depends on the warp only
      const float* qr = q_s + r * hd;
      const uint8_t* mrow =
          mask + ((size_t)b * Tq + t) * C + (size_t)g * page + c0;
      for (int j0 = 0; j0 < rows; j0 += 32) {
        const int j = j0 + lane;
        float s = kNeg;
        bool valid = false;
        if (j < rows) {
          const float* kr = k_s + j * ks;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
          valid = mrow[j] != 0;
          if (valid) s = dot * sm_scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float alpha = expf(m[rr] - m_new);
        const float pj = valid ? expf(s - m_new) : 0.f;
        l[rr] = l[rr] * alpha + warp_sum(pj);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
        const int nj = min(32, rows - j0);
        for (int jj = 0; jj < nj; ++jj) {
          const float pb = __shfl_sync(kFull, pj, jj);
          const float* vr = v_s + (j0 + jj) * ks;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d = lane + 32 * c;
            if (d < hd) acc[rr][c] = fmaf(pb, vr[d], acc[rr][c]);
          }
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp + rr * kWarps;
    if (t >= Tq) continue;
    T* orow = out + (bh * Tq + t) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store(orow + d, l[rr] > 0.f ? acc[rr][c] / l[rr] : 0.f);
    }
  }
}

template <typename T, typename KV, int NC, bool kChunked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ksc, const float* vsc, const int32_t* tables,
                   const uint8_t* mask, void* out, int B, int H, int Tq,
                   int hd, int page, int chunk, int G, int P1, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = (2 * (size_t)chunk * (hd + 1) + (size_t)kRowsPerBlock * hd)
                      * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, NC, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Tq + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  paged_decode_kernel<T, KV, NC, kChunked><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ksc, vsc, tables, mask, static_cast<T*>(out),
      H, Tq, hd, page, chunk, G, P1, sm_scale);
  return cudaGetLastError();
}

// A page that fits whole at head_dim <= 256 takes the instance sized to
// head_dim, without the chunk arithmetic.  A page staged in row chunks, or
// head_dim above 256, takes the one chunked instance per (T, KV), sized to
// head_dim 512 (columns past hd are skipped).
template <typename T, typename KV>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const float* ksc, const float* vsc,
                        const int32_t* tables, const uint8_t* mask, void* out,
                        int B, int H, int Tq, int hd, int page, int chunk, int G,
                        int P1, float sm_scale, cudaStream_t s) {
  if (chunk == page) {
    if (hd <= 32) return launch<T, KV, 1, false>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
    if (hd <= 64) return launch<T, KV, 2, false>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
    if (hd <= 128) return launch<T, KV, 4, false>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
    if (hd <= 256) return launch<T, KV, 8, false>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  }
  if (hd <= 512) return launch<T, KV, 16, true>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  return cudaErrorInvalidValue;
}

// A float pool shares q's type; a quantized pool needs both scale planes.
template <typename T>
cudaError_t dispatch_pool(int pool_dtype, int q_dtype, const void* q,
                          const void* k, const void* v, const float* ksc,
                          const float* vsc, const int32_t* tables,
                          const uint8_t* mask, void* out, int B, int H,
                          int Tq, int hd, int page, int chunk, int G, int P1,
                          float sm_scale, cudaStream_t s) {
  if (pool_dtype == q_dtype)
    return dispatch_hd<T, T>(q, k, v, nullptr, nullptr, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  if (ksc == nullptr || vsc == nullptr) return cudaErrorInvalidValue;
  if (pool_dtype == 2)
    return dispatch_hd<T, int8_t>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  if (pool_dtype == 3)
    return dispatch_hd<T, __nv_fp8_e4m3>(q, k, v, ksc, vsc, tables, mask, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  pool_dtype (both pools):
// q's own code, or 2 = int8, 3 = float8_e4m3fn with k_scale / v_scale
// [P1, H, page] float32 (null for a float pool).
// Layouts (all contiguous): q/out [B, H, Tq, hd]; k/v pools [P1, H, page, hd];
// tables [B, G] int32; mask [B, Tq, G*page] uint8.  hd <= 512; chunk (page
// rows staged at once, 1..page) sizes the dynamic shared memory,
// (2 * chunk * (hd + 1) + 16 * hd) * 4 bytes.  Launches on `stream`,
// does not synchronise, returns the launch's cudaError_t.
extern "C" int paged_flash_decode(int dtype, int pool_dtype, const void* q,
                                  const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* mask,
                                  void* out, int B, int H, int Tq, int hd,
                                  int page, int chunk, int G, int P1,
                                  float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tab = static_cast<const int32_t*>(tables);
  const uint8_t* msk = static_cast<const uint8_t*>(mask);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  if (chunk <= 0 || chunk > page) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_pool<float>(pool_dtype, dtype, q, k_pool, v_pool, ksc, vsc, tab, msk, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  if (dtype == 1)
    return dispatch_pool<__nv_bfloat16>(pool_dtype, dtype, q, k_pool, v_pool, ksc, vsc, tab, msk, out, B, H, Tq, hd, page, chunk, G, P1, sm_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
