// Quantized matmul with a fused dequantize + bias epilogue for Hopper
// (sm_90a): out[M, N] = float(xq[M, K] @ wq[K, N]) * scale[N] + bias[N].
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/quantized_matmul.py
// (_kernel / _qmm_pallas, reached through quantized_linear).  It computes
// the same function, not a block-by-block copy:
//   int8:  int8 x int8 products summed exactly in int32, then converted to
//          float32 (round to nearest even);
//   fp8:   e4m3 x e4m3 products (exact in float32) summed in float32;
//   both:  out = acc * scale[n] + bias[n] in float32, multiply then add with
//          separate roundings (no fused multiply-add), which is what the
//          plain PyTorch version does, so the int8 leg agrees with it bit
//          for bit.
// Any M, K, N: ragged edges are zero-filled (operands past K, M or N) and
// never stored.
//
// What bounds it on an H100: bytes at decode, operations only at
// admission.  On the serving path M is 8 (decode), 40 (1 + k verify) or up
// to 384 (admission) while the weight is 0.6-2.4 MB, so a call is one pass
// over the weight, (M*K + K*N) + 8*N + 4*M*N bytes: 0.7-1.4 us at
// 3.35 TB/s; fc2 at M = 384 is 1.8 GOP, ~1 us at 1979 TOP/s.  At that size
// the card is held back by how many bytes are in flight at once and by
// the launch, not by the math.
//
// What this design does about it:
//   * Tensor cores for both branches: mma.sync m16n8k32, s8 x s8 -> s32
//     (exact, so any order gives the same bits) and e4m3 x e4m3 -> f32.
//     Hopper's fp8 tensor-core sum keeps fewer bits than float32, so every
//     fp8 mma starts from zero and its 32-product sum is added into float32
//     registers at once (the promotion of DeepSeek-V3, section 3.3.2, at
//     every k-step).
//   * The 8-bit operands of the mma must be K-contiguous, and wq is [K, N]
//     row-major.  No transposed copy of the weight is kept (peak memory is
//     a metric of the quantized engines): each thread reads a patch of 4 K
//     rows x 4 (or 2) columns from shared memory and transposes it with
//     __byte_perm into words of 4 consecutive K.  The fragment's column
//     order is permuted so that one patch feeds four n-tiles (or both
//     halves of an m16 tile) at once; the epilogue undoes the permutation.
//   * The weight and the activations stream through a ring of 4 stages of
//     128-byte-deep K tiles with 16-byte cp.async copies, three tiles in
//     flight while one is multiplied (cp.async.wait_group).  Shared rows of
//     x are XOR-swizzled in 16-byte chunks so ldmatrix and the fragment
//     loads hit distinct banks.
//   * M <= 16 (decode, the small verify): out^T = wq^T . xq^T, so the
//     weight's columns fill the mma's 16-row slot and the <= 16 decode rows
//     its n8 slot; a block owns 16 columns and its 4 warps split each K
//     tile.  M > 16: 64 x 64 tiles, 4 warps of 32 x 32.
//   * Split-K across a thread-block cluster (up to 8 blocks along K), sized
//     so that a call covers the 132 SMs about twice: each block leaves its
//     partial sums in shared memory, and after a cluster barrier the blocks
//     of the cluster read every partial through distributed shared memory,
//     add them in split order (warps in order first), and run the epilogue
//     once.  The order is fixed, so two runs give the same bits in fp8 too;
//     no atomics, no workspace.
// Ragged shapes (K or N not a multiple of 16, unaligned pointers) fill the
// same stages with checked byte loads instead of cp.async.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 128;       // K elements (bytes) per stage
constexpr int kStages = 4;     // ring depth: 3 tiles in flight
constexpr int kMaxSplit = 8;   // the portable cluster size
constexpr int kWaves = 2;      // split K until the grid covers the SMs twice
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices: lanes 0-7 address the rows of the first, 8-15 of
// the second, 16-23 of the third, 24-31 of the fourth.  On 8-bit data a
// "row" is 16 bytes: thread (g, t) gets bytes 4t..4t+3 of row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x32, row-major) . b (32x8, column-major), s8 in, s32 out.
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b for e4m3: the tensor core sums the 32 products from zero and
// the float32 add below promotes the sum (see the header).
__device__ __forceinline__ void mma_k32(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float c[4];
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], c[e]);
}

// Rows r0..r3 of 4 byte columns each -> o[c] = column c's 4 bytes, row 0
// lowest.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows r0..r3 of 2 byte columns each (low 16 bits) -> c0, c1.
__device__ __forceinline__ void transpose4x2(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t& c0, uint32_t& c1) {
  const uint32_t p01 = (r0 & 0xffffu) | (r1 << 16);
  const uint32_t p23 = (r2 & 0xffffu) | (r3 << 16);
  c0 = __byte_perm(p01, p23, 0x6420);
  c1 = __byte_perm(p01, p23, 0x7531);
}

struct Args {
  const uint8_t* x;
  const uint8_t* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, K, N;
  int vec;  // cp.async legal: K, N multiples of 16, x, w 16-byte aligned
};

// Copy 16 bytes at src (n_ok of them inside the matrix) to dst, async when
// `vec` (then n_ok is 0 or 16), else by checked byte loads.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src,
                                       int n_ok, bool vec,
                                       const uint8_t* safe) {
  if (vec) {
    cp_async16(dst, n_ok > 0 ? src : safe, n_ok > 0 ? 16 : 0);
    return;
  }
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < n_ok && j < 16; ++j)
    wd[j >> 2] |= static_cast<uint32_t>(src[j]) << (8 * (j & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Geometry of the two designs.
//   SMALL (M <= 16): a block owns BN = 16 output columns and all M rows
//     (XR = 16, zero past M); warp w multiplies k-step w of every K tile.
//   large: a block owns a 64 x 64 tile, warp (wm, wn) a 32 x 32 quarter.
// Stage: x [XR][128] with chunk c of row r at c ^ (r & 7); w [128][BN]
// (large: chunk c of row k at c ^ 2 * ((k >> 2) & 1)).
template <bool SMALL>
struct Geo {
  static constexpr int BN = SMALL ? 16 : 64;
  static constexpr int BM = SMALL ? 16 : 64;
  static constexpr int XR = BM;
  static constexpr int XBYTES = XR * kBK;
  static constexpr int STAGE = XBYTES + kBK * BN;
};

__device__ __forceinline__ int wswz(int c, int k) {
  return c ^ (((k >> 2) & 1) << 1);
}

template <bool SMALL>
__device__ __forceinline__ void fill(uint8_t* st, const Args& a, int m0,
                                     int n0, int kt) {
  using G = Geo<SMALL>;
  const int k0 = kt * kBK;
  const bool vec = a.vec != 0;
  uint8_t* xs = st;
  uint8_t* ws = st + G::XBYTES;
  for (int i = threadIdx.x; i < G::XR * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const int m = m0 + r, k = k0 + 16 * c;
    const int n_ok = m < a.M && k < a.K ? min(16, a.K - k) : 0;
    copy16(xs + r * kBK + ((c ^ (r & 7)) << 4),
           a.x + (size_t)m * a.K + k, n_ok, vec, a.x);
  }
  constexpr int WCH = G::BN / 16;
  for (int i = threadIdx.x; i < kBK * WCH; i += kThreads) {
    const int r = i / WCH, c = i - r * WCH;
    const int k = k0 + r, n = n0 + 16 * c;
    const int n_ok = k < a.K && n < a.N ? min(16, a.N - n) : 0;
    const int pc = SMALL ? c : wswz(c, r);
    copy16(ws + r * G::BN + (pc << 4), a.w + (size_t)k * a.N + n, n_ok, vec,
           a.w);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
  if constexpr (std::is_same<T, float>::value) return __float_as_uint(v);
  else return static_cast<uint32_t>(v);
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t u) {
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(u);
  else return static_cast<T>(u);
}

template <bool FP8, bool SMALL, int MN>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(Args a) {
  using G = Geo<SMALL>;
  using Acc = typename std::conditional<FP8, float, int>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int S = gridDim.z, split = blockIdx.z;
  const int KT = (a.K + kBK - 1) / kBK;
  const int kt0 = (int)((long long)split * KT / S);
  const int nkt = (int)((long long)(split + 1) * KT / S) - kt0;

  // SMALL: acc[nt][e]; large: acc[i * 4 + j][e]
  constexpr int NT = SMALL ? MN : 8;
  Acc acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = Acc(0);

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nkt) fill<SMALL>(smem + p * G::STAGE, a, m0, n0, kt0 + p);
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; tile it - 1 consumed by all
    const int nx = it + kStages - 1;
    if (nx < nkt)
      fill<SMALL>(smem + (nx % kStages) * G::STAGE, a, m0, n0, kt0 + nx);
    cp_async_commit();
    const uint8_t* xs = smem + (it % kStages) * G::STAGE;
    const uint8_t* ws = xs + G::XBYTES;
    if constexpr (SMALL) {
      // A = the weight's 16 columns (row g <- column 2g, row g + 8 <-
      // column 2g + 1), B = x's rows; warp w takes k-step w of the tile
      const int kr = warp * 32 + 4 * t;
      uint32_t af[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q] = *reinterpret_cast<const uint16_t*>(
              ws + (kr + 16 * h + q) * G::BN + 2 * g);
        transpose4x2(r[0], r[1], r[2], r[3], af[2 * h], af[2 * h + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < MN; ++nt) {
        const int m = nt * 8 + g;
        const uint8_t* row = xs + m * kBK + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            row + (((2 * warp) ^ (m & 7)) << 4));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            row + (((2 * warp + 1) ^ (m & 7)) << 4));
        mma_k32(acc[nt], af, b0, b1);
      }
    } else {
      const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm * 32 + i * 16 + (lane & 15);
          const int c = 2 * ks + (lane >> 4);
          ldmatrix_x4(af[i], xs + r * kBK + ((c ^ (r & 7)) << 4));
        }
        // B: columns wn*32 + 4g + j (j = n-tile) from one 4x4 patch per
        // 16 K rows; logical column g of n-tile j
        uint32_t bf[2][4];
        const int c = wn * 2 + (g >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = ks * 32 + 16 * h + 4 * t + q;
            r[q] = *reinterpret_cast<const uint32_t*>(
                ws + k * G::BN + (wswz(c, k) << 4) + 4 * (g & 3));
          }
          transpose4x4(r[0], r[1], r[2], r[3], bf[h]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_k32(acc[i * 4 + j], af[i], bf[0][j], bf[1][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: partial sums go there

  // part[r][c]: the block's partial sum of tile row r, column c (SMALL:
  // its four warps' added in order), rows LDP words apart
  constexpr int LDP = G::BN + 4;  // 16-byte rows, fewer bank conflicts
  constexpr int ROWS = SMALL ? 8 * MN : G::BM;
  uint32_t* part = reinterpret_cast<uint32_t*>(smem);
  if constexpr (SMALL) {
    // thread (g, t) holds rows (m) nt * 8 + 2t, + 1 and columns 2g, 2g + 1
    uint32_t* wpart = part + ROWS * LDP;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wpart[(warp * ROWS + nt * 8 + 2 * t + (e & 1)) * LDP + 2 * g +
              (e >> 1)] = bits(acc[nt][e]);
    __syncthreads();
    for (int idx = tid; idx < ROWS * G::BN; idx += kThreads) {
      const int o = (idx / G::BN) * LDP + idx % G::BN;
      Acc s = from_bits<Acc>(wpart[o]);
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w)
        s += from_bits<Acc>(wpart[w * ROWS * LDP + o]);
      part[o] = bits(s);
    }
  } else {
    // warp (wm, wn), thread (g, t): rows wm * 32 + mi * 16 + g (+ 8),
    // columns wn * 32 + 8t .. 8t + 7 (n-tile j, logical column 2t or 2t + 1)
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mi = i >> 2, j = i & 3;
        part[(wm * 32 + mi * 16 + g + 8 * (e >> 1)) * LDP + wn * 32 +
             4 * (2 * t + (e & 1)) + j] = bits(acc[i][e]);
      }
  }
  cluster.sync();  // every block's partials are in place

  // the cluster's blocks share the tile's 4-column groups: each adds the
  // S partials of its groups in split order and runs the epilogue
  constexpr int NQ = G::BN / 4;
  const int rank = (int)cluster.block_rank();
  const bool vec_out = a.N % 4 == 0;
  for (int idx = rank * kThreads + tid; idx < ROWS * NQ;
       idx += S * kThreads) {
    const int r = idx / NQ, q = idx - r * NQ;
    const uint4* src = reinterpret_cast<const uint4*>(part + r * LDP + 4 * q);
    uint4 v = *cluster.map_shared_rank(src, 0);
    Acc sum[4] = {from_bits<Acc>(v.x), from_bits<Acc>(v.y),
                  from_bits<Acc>(v.z), from_bits<Acc>(v.w)};
    for (int rr = 1; rr < S; ++rr) {
      v = *cluster.map_shared_rank(src, rr);
      sum[0] += from_bits<Acc>(v.x);
      sum[1] += from_bits<Acc>(v.y);
      sum[2] += from_bits<Acc>(v.z);
      sum[3] += from_bits<Acc>(v.w);
    }
    const int m = m0 + r, n = n0 + 4 * q;
    if (m >= a.M || n >= a.N) continue;
    float o4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o4[e] = n + e < a.N ? __fadd_rn(__fmul_rn(static_cast<float>(sum[e]),
                                                a.scale[n + e]),
                                      a.bias[n + e])
                          : 0.f;
    float* dst = a.out + (size_t)m * a.N + n;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(o4[0], o4[1], o4[2], o4[3]);
    } else {
      for (int e = 0; e < 4 && n + e < a.N; ++e) dst[e] = o4[e];
    }
  }
  cluster.sync();  // no block leaves while its partials are read
}

template <bool FP8, bool SMALL, int MN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geo<SMALL>;
  auto kernel = qmm_kernel<FP8, SMALL, MN>;
  const long long tiles_n = (a.N + G::BN - 1) / G::BN;
  const long long tiles_m = SMALL ? 1 : (a.M + G::BM - 1) / G::BM;
  if (tiles_m > 65535 || tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  // per device, looked up once: the SM count and the shared-memory opt-in
  // (a host call each launch would cost as much as the kernel at decode)
  static int sms_of[kMaxDevices] = {};
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const int sms = sms_of[dev];
  const int KT = (a.K + kBK - 1) / kBK;
  const long long tiles = tiles_n * tiles_m;
  long long S = (kWaves * (long long)sms + tiles - 1) / tiles;
  S = S < kMaxSplit ? S : kMaxSplit;
  S = S < KT ? S : KT;
  if (S < 1) S = 1;
  const int smem = kStages * G::STAGE;
  if (smem > 48 * 1024 && !smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles_n, (unsigned)tiles_m, (unsigned)S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool FP8>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.M <= 8) return launch<FP8, true, 1>(a, s);
  if (a.M <= 16) return launch<FP8, true, 2>(a, s);
  return launch<FP8, false, 1>(a, s);
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
  if (M < 1 || N < 1 || K < 0) return cudaErrorInvalidValue;
  Args a{static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(wq),
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         static_cast<float*>(out), M, K, N, 0};
  a.vec = K % 16 == 0 && N % 16 == 0 &&
          reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (dtype == 0) return dispatch<false>(a, s);
  if (dtype == 1) return dispatch<true>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* quantized_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
