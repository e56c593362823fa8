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
//   times k_scale[p, h, j] (v likewise), so a float K/V view never exists in
//   device memory.
//
// What bounds it on an H100: bytes.  Each (b, h) reads its slot's valid K
// and V pages once (page * hd elements each, per page; one byte an element
// plus 4 bytes a key of scale for a quantized pool), a few flops per byte,
// far below the ~295 flop/byte ridge of the card; at decode T = 1 the work
// is a pure stream of the KV pages.  At serving's shapes that stream is
// ~28 MB, 8.4 us at 3.35 TB/s: the call is short, so what decides its time
// is how many page loads are in flight at once and how long each block's
// chain of dependent steps is.
//
// The split design (paged_split_kernel, entry paged_flash_decode_split):
//   * a cluster of S blocks (S <= 8, the portable cluster size) serves each
//     (b, h, tile of R query rows); the slot's pages are split between them,
//     so B * H * tiles * S blocks share the walk (768 at decode with S = 8,
//     against the first design's 96);
//   * every block first reads the tile's mask rows into a bitmap (one bit a
//     key) and lists the pages that some row of the tile can see: a page
//     whose mask is 0 for every row adds exactly 0 to acc and to l, so the
//     walk visits the listed pages only, however the table is laid out
//     (serving's short slots skip most of their G entries).  The mask is
//     the source of truth: no length argument is read;
//   * block r of the cluster takes the r-th contiguous share of that list.
//     One producer warp copies each page of K and V (and a quantized pool's
//     two scale rows) into a ring of 4 shared-memory stages with
//     TMA's 1-D bulk copy (cp.async.bulk, one copy per contiguous
//     page * hd block of the [P1, H, page, hd] pool) completing on the
//     stage's mbarrier; the consumers issue no load and the next pages'
//     bytes land while this page is scored;
//   * four consumer warps take the share's pages in turn, so every warp has
//     work at T = 1.  In a warp, lane (j, half) scores key j of a 16-key
//     group over half of head_dim (the halves added by one shuffle), rows
//     of the tile in registers; p . v then gives each lane head_dim columns.
//     A quantized code is multiplied by its scale in registers, at use;
//   * each warp's partial (m, l, acc[hd]) a row goes to shared memory; the
//     block merges its warps in warp order, and after a cluster barrier the
//     S blocks' partials are merged through distributed shared memory in
//     rank order (m = max m_i, l = sum l_i e^(m_i - m), acc likewise), each
//     block writing a share of the tile's outputs.  A share with no valid
//     key merges as l = 0 (m_i = -1e30: e^(m_i - m) is 0, or 1 times l = 0
//     when the whole row is masked, which then writes exactly 0).  Fixed
//     orders, no atomics, no scratch: two runs give the same bits.
//   Taken (paged_attention.py decides up front, by shape) for head_dim a
//   multiple of 16 up to 256 and a page a multiple of 16 whose ring fits in
//   shared memory.
//
// The first design (paged_decode_kernel, entry paged_flash_decode), kept
// for every other shape (a page larger than shared memory, head_dim
// 257-512, a page or head_dim off the 16 grid): one block per (b, h,
// 16-row T tile) streams each of the G pages of K and V from the pool into
// shared memory, synchronously, and serves every query row of the tile
// from there (the dequantizing multiply as the page is staged), so the
// [B, H, G*page, hd] gathered view the plain version builds never exists.
// A page whose K and V do not fit in shared memory beside the q tile (page
// 1024 at hd 64) is staged in chunks of rows, the online softmax running
// on across them; that path and head_dim 257-512 share one instance per
// dtype pair.  Shared rows are padded to hd + 1 floats so the lane-per-key
// dot products hit distinct banks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entries,
// bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace cg = cooperative_groups;

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


// ---------------------------------------------------------------------------
// The split design: a cluster of blocks per (b, h, row tile), an
// asynchronous walk over the valid pages only
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 4;                         // consumer warps
constexpr int kSplitThreads = (kSplitWarps + 1) * 32;  // + the producer warp
constexpr int kKeyGroup = 16;   // keys a warp scores at once; a mask word
constexpr int kMaxSplit = 8;    // the portable cluster size
// The ring's depth.  Warp w takes pages w, w + 4, ..., so with a multiple
// of the warps a stage's previous page was its own warp's, and a warp
// never waits on an mbarrier two phases ahead (8 stages measured no faster
// than 4 at serving's shapes, and slower over float pools).
constexpr int kStages = 4;
static_assert(kStages % kSplitWarps == 0, "a stage serves one warp");

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  const uint8_t* mask;
  void* out;
  int H, Tq, hd, page, G, P1;
  float sm_scale;
};

// Byte offsets of one block's shared memory, in the order the kernel
// carves it: the ring of stages (K page, V page, then a quantized pool's two
// scale rows), the full / empty barriers and the page count, the q tile
// (float32), the partials (m, l, acc[hd] a row) of the warps and of the
// block, the tile's mask bits (one 16-bit word a row and 16 keys), the
// slot's table and the list of pages to visit.
struct SplitSmem {
  int stage, bars, q, part, bits, tab, list, total;
  __host__ __device__ SplitSmem(int R, int hd, int page, int G,
                                int kv_size) {
    stage = 2 * page * hd * kv_size + (kv_size == 1 ? 2 * page * 4 : 0);
    bars = kStages * stage;
    q = bars + 16 * kStages + 16;
    part = q + R * hd * 4;
    bits = part + (kSplitWarps + 1) * R * (hd + 2) * 4;
    tab = bits + ((R * G * page / kKeyGroup * 2 + 15) & ~15);
    list = tab + G * 4;
    total = list + G * 4;
  }
};

// One bit for each nonzero byte of x, byte i at bit i.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) |
         (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

// The online softmax's merge of partials (m_i, l_i, acc_i): with
// M = max m_i, l = sum l_i e^(m_i - M) and acc likewise, in index order.
// part(i) points at partial i's [m, l, acc[hd]]; d < 0 asks for l.
template <typename Part>
__device__ __forceinline__ void merge(int n, int d, Part part, float& M,
                                      float& x) {
  M = kNeg;
  for (int i = 0; i < n; ++i) M = fmaxf(M, part(i)[0]);
  x = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* pi = part(i);
    x += pi[d < 0 ? 1 : 2 + d] * expf(pi[0] - M);
  }
}

// NC: 32-wide chunks of head_dim a lane accumulates (hd <= 32 * NC); R:
// query rows a block serves (the tile).  T: q / out element type; KV: the
// pool's (T itself, or int8_t / __nv_fp8_e4m3 with scale rows).  Warps 0-3
// consume, warp 4 produces.  Block `rank` of a cluster of S serves the
// rank-th share of the tile's page list.
template <typename T, typename KV, int NC, int R>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const SplitArgs a) {
  constexpr bool kQuant = sizeof(KV) == 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = (blockIdx.x / S) * R;
  const int rows = min(R, a.Tq - t0);
  const int hd = a.hd, page = a.page, G = a.G;
  const int words = G * page / kKeyGroup;  // mask words a row
  const int page_words = page / kKeyGroup;
  const int page_elems = page * hd;
  const int kv_bytes = page_elems * (int)sizeof(KV);
  const SplitSmem L(R, hd, page, G, (int)sizeof(KV));
  extern __shared__ __align__(128) unsigned char smem_split[];
  unsigned char* ring = smem_split;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_split + L.bars);
  uint64_t* empty = full + kStages;
  int* n_pages = reinterpret_cast<int*>(empty + kStages);
  float* q_s = reinterpret_cast<float*>(smem_split + L.q);
  float* part = reinterpret_cast<float*>(smem_split + L.part);
  float* block_part = part + kSplitWarps * R * (hd + 2);
  uint16_t* bits = reinterpret_cast<uint16_t*>(smem_split + L.bits);
  int* tab = reinterpret_cast<int*>(smem_split + L.tab);
  int* list = reinterpret_cast<int*>(smem_split + L.list);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * a.H + h;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const T* q = static_cast<const T*>(a.q) + (bh * a.Tq + t0) * hd;
  for (int i = tid; i < R * hd; i += kSplitThreads)
    q_s[i] = i < rows * hd ? to_f32(q[i]) : 0.f;
  // unmapped entries arrive clipped to a valid page and fully masked;
  // clamp anyway so a bad table can never read outside the pool
  for (int g = tid; g < G; g += kSplitThreads)
    tab[g] = min(max(a.tables[(size_t)b * G + g], 0), a.P1 - 1);
  // the tile's mask rows as bits, 16 keys (one 16-byte load) a word
  const uint8_t* mask = a.mask + ((size_t)b * a.Tq + t0) * G * page;
  for (int i = tid; i < R * words; i += kSplitThreads) {
    uint32_t w = 0;
    if (i < rows * words) {
      const uint4 v = *reinterpret_cast<const uint4*>(mask + (size_t)i * 16);
      w = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
          nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
    }
    bits[i] = (uint16_t)w;
  }
  __syncthreads();

  // the pages some row of the tile can see, in table order
  if (warp == 0) {
    int n = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      uint32_t any = 0;
      if (g < G)
        for (int r = 0; r < rows; ++r)
          for (int w = 0; w < page_words; ++w)
            any |= bits[r * words + g * page_words + w];
      const unsigned bal = __ballot_sync(kFull, any != 0);
      if (any) list[n + __popc(bal & ((1u << lane) - 1))] = g;
      n += __popc(bal);
    }
    if (lane == 0) *n_pages = n;
  }
  __syncthreads();
  const int n = *n_pages;
  const int lo = rank * n / S, cnt = (rank + 1) * n / S - lo;

  if (warp == kSplitWarps) {
    // the producer: one bulk copy per page of K and of V (and per scale
    // row) into the ring, a stage at a time as the consumers free them
    if (lane == 0) {
      for (int i = 0; i < cnt; ++i) {
        const int st = i % kStages;
        if (i >= kStages) sm90::mbar_wait(&empty[st], (i / kStages - 1) & 1);
        const size_t ph = (size_t)tab[list[lo + i]] * a.H + h;
        unsigned char* dst = ring + st * L.stage;
        sm90::mbar_expect_tx(&full[st], L.stage);
        sm90::bulk_load(dst, static_cast<const KV*>(a.k) + ph * page_elems,
                        kv_bytes, &full[st]);
        sm90::bulk_load(dst + kv_bytes,
                        static_cast<const KV*>(a.v) + ph * page_elems,
                        kv_bytes, &full[st]);
        if constexpr (kQuant) {
          sm90::bulk_load(dst + 2 * kv_bytes, a.k_scale + ph * page,
                          page * 4, &full[st]);
          sm90::bulk_load(dst + 2 * kv_bytes + page * 4,
                          a.v_scale + ph * page, page * 4, &full[st]);
        }
      }
    }
    __syncwarp();
  } else {
    // a consumer warp: pages warp, warp + 4, ... of the share.  Lane
    // (half, j) scores key j of each 16-key group over head_dim columns
    // [half * hd / 2, (half + 1) * hd / 2), from column lane on (mod
    // hd / 2), so the 32 lanes' k and q reads fall in distinct banks
    float m[R], l[R], acc[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }
    const int j = lane & (kKeyGroup - 1), half = lane >> 4;
    const int dh = hd >> 1;
    const float* qh = q_s + half * dh;
    for (int i = warp; i < cnt; i += kSplitWarps) {
      const int st = i % kStages;
      sm90::mbar_wait(&full[st], (i / kStages) & 1);
      const KV* kst = reinterpret_cast<const KV*>(ring + st * L.stage);
      const KV* vst = kst + page_elems;
      const float* ksc =
          reinterpret_cast<const float*>(ring + st * L.stage + 2 * kv_bytes);
      const float* vsc = ksc + page;
      const uint16_t* pbits = bits + list[lo + i] * page_words;
      for (int j0 = 0; j0 < page; j0 += kKeyGroup) {
        const int key = j0 + j;
        const KV* kr = kst + key * hd + half * dh;
        const float kscale = kQuant ? ksc[key] : 1.f;
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.f;
        int d = lane % dh;
        for (int c = 0; c < dh; ++c) {
          float kv = to_f32(kr[d]);
          if constexpr (kQuant) kv *= kscale;  // dequantized at use
#pragma unroll
          for (int r = 0; r < R; ++r) s[r] = fmaf(qh[r * hd + d], kv, s[r]);
          d = d + 1 == dh ? 0 : d + 1;
        }
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] += __shfl_xor_sync(kFull, s[r], 16);  // the two halves
          const bool valid = (pbits[r * words + (j0 >> 4)] >> j) & 1u;
          const float sc = valid ? s[r] * a.sm_scale : kNeg;
          float mx = sc;
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          const float m_new = fmaxf(m[r], mx);
          const float alpha = expf(m[r] - m_new);
          p[r] = valid ? expf(sc - m_new) : 0.f;
          float ps = p[r];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
          l[r] = l[r] * alpha + ps;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
          m[r] = m_new;
        }
        // p . v: lane owns columns lane + 32 c; key jj's p from lane jj
        for (int jj = 0; jj < kKeyGroup; ++jj) {
          const KV* vr = vst + (j0 + jj) * hd;
          const float vscale = kQuant ? vsc[j0 + jj] : 1.f;
          float vv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int dd = lane + 32 * c;
            vv[c] = dd < hd ? to_f32(vr[dd]) : 0.f;
            if constexpr (kQuant) vv[c] *= vscale;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float pb = __shfl_sync(kFull, p[r], jj);
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pb, vv[c], acc[r][c]);
          }
        }
      }
      __syncwarp();  // every lane is done with the stage
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }
    float* wp = part + warp * R * (hd + 2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        wp[r * (hd + 2)] = m[r];
        wp[r * (hd + 2) + 1] = l[r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = lane + 32 * c;
        if (dd < hd) wp[r * (hd + 2) + 2 + dd] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // the block's partial: its warps merged in warp order
  for (int o = tid; o < rows * (hd + 1); o += kSplitThreads) {
    const int r = o / (hd + 1), d = o - r * (hd + 1) - 1;  // d = -1: l
    float M, x;
    merge(kSplitWarps, d, [&](int w) { return part + (w * R + r) * (hd + 2); },
          M, x);
    float* bp = block_part + r * (hd + 2);
    if (d < 0) {
      bp[0] = M;
      bp[1] = x;
    } else {
      bp[2 + d] = x;
    }
  }
  cluster.sync();  // every block's partial is in place

  // the cluster's partials merged in rank order, each block writing every
  // S-th output of the tile
  T* out = static_cast<T*>(a.out) + (bh * a.Tq + t0) * hd;
  for (int o = tid * S + rank; o < rows * hd; o += kSplitThreads * S) {
    const int r = o / hd, d = o - r * hd;
    float M, lsum, x;
    auto at = [&](int s) {
      return cluster.map_shared_rank(block_part, s) + r * (hd + 2);
    };
    merge(S, -1, at, M, lsum);
    merge(S, d, at, M, x);
    store(out + o, lsum > 0.f ? x / lsum : 0.f);
  }
  cluster.sync();  // no block leaves while its partial may still be read
}

template <typename T, typename KV, int NC, int R>
cudaError_t launch_split(const SplitArgs& a, int B, int S,
                         cudaStream_t stream) {
  const SplitSmem L(R, a.hd, a.page, a.G, (int)sizeof(KV));
  if (L.total > 232448) return cudaErrorInvalidValue;
  auto kernel = paged_split_kernel<T, KV, NC, R>;
  // the largest shared memory this instance was allowed so far, per device
  // (set outside any CUDA graph capture: the first call is eager)
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (L.total > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.total);
    if (e != cudaSuccess) return e;
    allowed[dev] = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(S * ((a.Tq + R - 1) / R)), (unsigned)a.H,
                     (unsigned)B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The instance sized to head_dim (hd <= 32 NC) and the tile's rows.
template <typename T, typename KV>
cudaError_t split_hd(const SplitArgs& a, int B, int S, int R,
                     cudaStream_t s) {
  if (a.hd <= 64) {
    if (R == 1) return launch_split<T, KV, 2, 1>(a, B, S, s);
    if (R == 8) return launch_split<T, KV, 2, 8>(a, B, S, s);
    if (R == 16) return launch_split<T, KV, 2, 16>(a, B, S, s);
  } else if (a.hd <= 128) {
    if (R == 1) return launch_split<T, KV, 4, 1>(a, B, S, s);
    if (R == 8) return launch_split<T, KV, 4, 8>(a, B, S, s);
    if (R == 16) return launch_split<T, KV, 4, 16>(a, B, S, s);
  } else if (a.hd <= 256) {
    if (R == 1) return launch_split<T, KV, 8, 1>(a, B, S, s);
    if (R == 8) return launch_split<T, KV, 8, 8>(a, B, S, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t split_pool(int pool_dtype, int q_dtype, const SplitArgs& a,
                       int B, int S, int R, cudaStream_t s) {
  if (pool_dtype == q_dtype) return split_hd<T, T>(a, B, S, R, s);
  if (a.k_scale == nullptr || a.v_scale == nullptr)
    return cudaErrorInvalidValue;
  if (pool_dtype == 2) return split_hd<T, int8_t>(a, B, S, R, s);
  if (pool_dtype == 3) return split_hd<T, __nv_fp8_e4m3>(a, B, S, R, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

// The split design.  Arguments as paged_flash_decode's, and: split, the
// blocks of a cluster (1..8) that share each (b, h, tile)'s pages; rows,
// the query rows of a tile (1, 8, or 16 where hd <= 128).  It takes hd a multiple of 16 up to 256, page a multiple of
// 16, every pointer 16-byte aligned, and a ring that fits in shared memory
// (paged_attention.py's plan); anything else returns cudaErrorInvalidValue.
extern "C" int paged_flash_decode_split(
    int dtype, int pool_dtype, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* mask, void* out, int B, int H, int Tq,
    int hd, int page, int G, int P1, float sm_scale, int split, int rows,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || split > kMaxSplit || hd % 16 != 0 || hd > 256 ||
      page % kKeyGroup != 0 || B < 1 || H < 1 || Tq < 1 || G < 1 || P1 < 1)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool) ||
      !aligned16(k_scale) || !aligned16(v_scale) || !aligned16(mask) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const SplitArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int32_t*>(tables),
                    static_cast<const uint8_t*>(mask), out, H, Tq, hd, page,
                    G, P1, sm_scale};
  if (dtype == 0) return split_pool<float>(pool_dtype, 0, a, B, split, rows, s);
  if (dtype == 1)
    return split_pool<__nv_bfloat16>(pool_dtype, 1, a, B, split, rows, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_flash_decode_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
