// Fused softmax cross-entropy forward for Hopper (sm_90a): one pass over
// the vocabulary, no [M, V] probability matrix.
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/fused_softmax_xent.py
// (_kernel / _sxent_pallas, public entry softmax_cross_entropy).  It
// computes the same function, for each row i of logits [M, V]:
//   lse[i]  = log(sum_j exp(f32(logits[i, j])))       online, max-shifted
//   loss[i] = lse[i] - f32(logits[i, labels[i]])       if 0 <= label < V
//           = lse[i]                                   otherwise
// both written as f32 [M]; lse is saved for the backward.
//
// What bounds it on an H100: bytes.  Each logit is read once and used for
// one exp and a few flops; the outputs are 8 bytes a row.  GPT-small's
// [8184, 50304] f32 call reads 1.647 GB (~492 us at 3.35 TB/s), BERT-base's
// [5120, 30522] bf16 call 312.6 MB (~93 us).
//
// What this first design does about it: one block per row streams the row
// once.  Each thread walks the columns threadIdx.x, +256, ... in chunks of
// eight loads issued together, and keeps an online (max, sum of exp) pair:
// per chunk, one rescale exp(m - m_new) and eight exp(v - m_new).  The
// pairs combine across the warp by shuffles and across the eight warps in
// shared memory with the same rescale sum * exp(m - m_new).  The thread
// that owns column labels[i] in that walk contributes the label logit.
// Nothing vocabulary-sized is written.  Not done yet (later work): 16-byte
// vector loads, several rows per block for small V, and the backward as a
// kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Merge the running pair (m, l) with (mo, lo): both are (max, sum of
// exp(x - max)) over disjoint sets.  A side that saw only -inf has l = 0.
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty so far
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sxent_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
             float* __restrict__ loss, float* __restrict__ lse_out, int V) {
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_hit;
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * V;
  const int lab = labels[row];
  const bool has = lab >= 0 && lab < V;

  float m = -INFINITY, l = 0.f;
  int j = threadIdx.x;
  for (; j + (kChunk - 1) * kThreads < V; j += kChunk * kThreads) {
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = to_f32(x[j + u * kThreads]);
    float mc = v[0];
#pragma unroll
    for (int u = 1; u < kChunk; ++u) mc = fmaxf(mc, v[u]);
    const float mn = fmaxf(m, mc);
    if (mn > -INFINITY) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) acc += expf(v[u] - mn);
      l = l * expf(m - mn) + acc;
      m = mn;
    }
  }
  for (; j < V; j += kThreads) {
    const float v = to_f32(x[j]);
    const float mn = fmaxf(m, v);
    if (mn > -INFINITY) {
      l = l * expf(m - mn) + expf(v - mn);
      m = mn;
    }
  }

  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(kFull, m, o);
    const float lo = __shfl_xor_sync(kFull, l, o);
    merge(m, l, mo, lo);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  // the owner of column `lab` in the strided walk above
  if (has && threadIdx.x == lab % kThreads) s_hit = to_f32(x[lab]);
  __syncthreads();
  if (threadIdx.x == 0) {
    float mt = s_m[0], lt = s_l[0];
    for (int w = 1; w < kWarps; ++w) merge(mt, lt, s_m[w], s_l[w]);
    const float lse = mt + logf(lt);
    lse_out[row] = lse;
    loss[row] = has ? lse - s_hit : lse;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int32_t* labels, float* loss,
                   float* lse, int M, int V, cudaStream_t stream) {
  sxent_kernel<T><<<M, kThreads, 0, stream>>>(static_cast<const T*>(logits),
                                               labels, loss, lse, V);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits).  Layouts (all contiguous):
// logits [M, V]; labels [M] int32; loss, lse [M] f32.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t.
extern "C" int softmax_xent_fwd(int dtype, const void* logits,
                                const void* labels, void* loss, void* lse,
                                int M, int V, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (M <= 0 || V <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(logits, lab, lo, ls, M, V, st);
  if (dtype == 1) return launch<__nv_bfloat16>(logits, lab, lo, ls, M, V, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* softmax_xent_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
