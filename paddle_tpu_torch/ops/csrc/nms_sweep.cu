// Greedy NMS sweep for Hopper (sm_90a): the keep decisions of the
// sequential loop of non-maximum suppression, one thread block per
// instance.
//
// Replaces no TPU kernel.  On the TPU, nms's keep loop
// (paddle_tpu/nn/functional/detection.py:340-352, a lax.fori_loop over the
// score-sorted candidates) compiles to one XLA loop.  In PyTorch that loop
// would be a Python loop of about five launches a candidate: a Faster
// R-CNN training step keeps k = 12000 candidates per image, some 120,000
// launches for two images.  This kernel makes the whole sweep one launch.
//
// It computes, for each instance b of iou [B, k, k] (the pairwise IoU of
// the instance's candidates in descending score order) and its sorted
// scores [B, k], with t_0 = threshold:
//   keep[i] = isfinite(score[i]) && !(max_{j < i, keep[j]} iou[i, j] > t_i)
//   t_{i+1} = t_i * eta   if keep[i] && eta < 1 && t_i > 0.5, else t_i
// the decisions of the loop body (detection.py:341-348), the decaying
// threshold included.  "Any kept j with iou > t" is "the largest IoU with
// a kept j is > t", so the max over kept boxes decides; a NaN IoU
// suppresses nothing in both forms.  t is float32 and t * eta is rounded
// to float32, as in the loop.
//
// What bounds it: latency.  The sweep is sequential in its decisions, and
// the work it needs (reading iou[i, j] for every live i and every kept
// j < i) is 4 bytes a pair, gathered; it depends on the data.
//
// What the design does about it: candidates go in tiles of 32, one per
// warp of the 1024-thread block.  Phase 1: each warp takes the max of its
// candidate's row over the boxes kept before the tile (the lanes stride
// over the kept list, then a shuffle reduction), all 32 candidates at
// once.  Phase 2: warp 0 resolves the tile in order with shuffles: lane j
// decides against the threshold, and if it keeps, every later lane folds
// iou[i_l, i_j] into its max and the threshold decays.  The kept
// candidates are appended to the instance's kept list (global scratch, in
// order) and the block moves on: one __syncthreads pair per 32
// candidates instead of per candidate.  Candidates whose score is not
// finite are never kept and cost nothing; the sweep stops at the first
// -inf score of a tile's head, since the scores are sorted.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float* __restrict__ iou, const float* __restrict__ scores,
                 uint8_t* __restrict__ keep, int32_t* __restrict__ kept_list,
                 int k, float threshold, float eta) {
  __shared__ float s_max[kWarps];
  __shared__ int s_kept;
  __shared__ float s_thr;
  __shared__ int s_stop;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* rows = iou + (size_t)b * k * k;
  const float* sc = scores + (size_t)b * k;
  uint8_t* kp = keep + (size_t)b * k;
  int32_t* kl = kept_list + (size_t)b * k;
  if (threadIdx.x == 0) {
    s_kept = 0;
    s_thr = threshold;
    s_stop = 0;
  }
  __syncthreads();

  for (int base = 0; base < k; base += kWarps) {
    // phase 1: warp w -> the max IoU of candidate base + w with every box
    // kept before this tile
    const int n_kept = s_kept;
    const int i = base + warp;
    float m = -INFINITY;
    if (i < k && isfinite(sc[i])) {
      const float* row = rows + (size_t)i * k;
      for (int t = lane; t < n_kept; t += 32) m = fmaxf(m, row[kl[t]]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    }
    if (lane == 0) s_max[warp] = m;
    __syncthreads();

    // phase 2: warp 0 decides the tile's 32 candidates in order
    if (warp == 0) {
      const int il = base + lane;
      const bool live = il < k && isfinite(sc[il]);
      const float* row = rows + (size_t)(live ? il : 0) * k;
      float ml = s_max[lane];
      float thr = s_thr;
      bool mine = false;
      for (int j = 0; j < kWarps; ++j) {
        const bool kj = __shfl_sync(kFull, live && !(ml > thr), j);
        if (!kj) continue;
        if (lane == j) mine = true;
        if (lane > j && live) ml = fmaxf(ml, row[base + j]);
        if (eta < 1.f && thr > 0.5f) thr = thr * eta;
      }
      const unsigned kept_mask = __ballot_sync(kFull, mine);
      if (mine) {
        kp[il] = 1;
        kl[n_kept + __popc(kept_mask & ((1u << lane) - 1u))] = il;
      }
      if (lane == 0) {
        s_kept = n_kept + __popc(kept_mask);
        s_thr = thr;
        // sorted scores: a -inf at the next tile's head ends the sweep
        const int nb = base + kWarps;
        s_stop = nb < k && sc[nb] == -INFINITY;
      }
    }
    __syncthreads();
    if (s_stop) break;
  }
}

}  // namespace

// Layouts (all contiguous): iou [B, k, k] f32; scores [B, k] f32, each row
// sorted descending; keep [B, k] uint8, zeroed by the caller (the kernel
// writes the 1s); kept_list [B, k] int32 scratch.  One block an instance.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int nms_sweep(const void* iou, const void* scores, void* keep,
                         void* kept_list, int B, int k, float threshold,
                         float eta, void* stream) {
  if (B <= 0 || k <= 0) return cudaErrorInvalidValue;
  nms_sweep_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(kept_list), k,
      threshold, eta);
  return cudaGetLastError();
}

extern "C" const char* nms_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
