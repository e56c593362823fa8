// Fused residual add + LayerNorm for Hopper (sm_90a): forward and backward.
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
// Dtypes, as the TPU kernel takes them: T (x, s, y, and the backward's dy,
// ds_out and ds) is float32, bfloat16 or float16; the residual r is T or
// float32; g and b are one dtype, T or float32, and dg, db come out in it.
// A float32 T takes float32 for all.  Mixed operands are what mixed
// precision (amp O1) hands the kernel: a bf16 sublayer output with an f32
// residual stream and f32 LayerNorm parameters.  Each operand is read at
// its own width: where T's 16-byte vector holds E values, a float32 operand
// is read as two 16-byte vectors of the same E columns.
//
// The backward is the same module's _ln_res_bwd, the closed-form LayerNorm
// VJP that XLA fuses into one pass on a TPU; here it is one pass too:
//   xhat = (f32(s) - mean) * rstd;  dxhat = f32(dy) * f32(g)
//   m1 = sum(dxhat) / D;  m2 = sum(dxhat * xhat) / D
//   ds = round_to_T(rstd * (dxhat - m1 - xhat * m2) [+ f32(ds_out)])
//   dg = sum over rows of f32(dy) * xhat;  db = sum over rows of f32(dy)
//
// What bounds both on an H100: bytes.  The forward reads x and r and writes
// s and y once (4 * D * itemsize bytes a row, plus 8 bytes of statistics);
// the backward reads s, dy (and ds_out) and writes ds once.  A handful of
// flops an element, far below the card's flop/byte ridge.  BERT-base
// pretraining's [32768, 768] bf16 forward moves 201.6 MB (~60 us at 3.35
// TB/s), its backward 151 MB (~45 us); under amp O1 an f32 residual adds
// 50 MB to the forward.
//
// The Hopper design (ln_res_vec_kernel, ln_bwd_kernel), for D <= 1024 (32
// lanes x VPL <= 32 values, VPL a multiple of 8): one warp a row with the
// row in registers, so nothing passes through shared memory and no block
// barrier is taken per row; every access is a 16-byte vector (8 bf16 or 4
// f32: lane l holds vectors l, l + 32, ...) where D * itemsize is a multiple
// of 16 and the pointers are 16-byte aligned (the wrapper's plan); a
// persistent grid (about SMs x occupancy blocks) in which each warp walks
// rows with a fixed stride, keeping g and b in registers (forward) and its
// columns' dg / db partial sums in registers (backward) for every row it
// takes; the forward issues the next row's loads before the current row's
// shuffles, so a warp has two rows in flight (a ring of 2 or 4 rows staged
// by 1-D bulk copies measured no faster; the backward keeps one row: its
// column sums take the registers a second row would need).  The backward's
// dg / db sums use no float atomics: each block adds its warps' partials in
// warp order through shared memory and writes one partial row, and a
// second short launch (ln_bwd_reduce_kernel) adds the blocks' rows per
// column in block order, so two calls are bit-equal.  The backward also
// runs with element loads (VEC = false, lane l holds columns l, l + 32,
// ...) for rows that are not whole vectors or not aligned.
//
// The first design (ln_res_kernel, ln_res_wide_kernel) stays for the
// forward's other shapes: for D <= 768 one warp per row with scalar loads,
// four rows per 128-thread block; for 768 < D <= 49152 one block per row
// with the row in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entries,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// T: x, s, y; TR: r; TW: g, b.
template <typename T, typename TR, typename TW, int VPT>
__global__ void __launch_bounds__(kThreads)
ln_res_kernel(const T* __restrict__ x, const TR* __restrict__ r,
              const TW* __restrict__ g, const TW* __restrict__ b,
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

template <typename T, typename TR, typename TW>
__global__ void __launch_bounds__(kWideThreads)
ln_res_wide_kernel(const T* __restrict__ x, const TR* __restrict__ r,
                   const TW* __restrict__ g, const TW* __restrict__ b,
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

// ---------------------------------------------------------------------------
// The Hopper design.  A lane's share of a row is VPL values: in the vector
// layout VPL / E groups of E columns, E the values of T in a 16-byte vector
// (group i of lane l holds columns (l + 32 i) E .. + E), each group one
// 16-byte vector of an operand in T and two of a float32 operand beside a
// 16-bit T; in the element layout VPL scalars (column l + 32 k).  Slot k of
// a lane is column col(k); a slot past D holds 0 and is masked.

constexpr int kMaxVPL = 32;  // D <= 32 x 32 = 1024

template <typename T>
struct Elems {
  static constexpr int E = 16 / sizeof(T);  // 4 float32, 8 bf16 / fp16
};

__device__ __forceinline__ void unpack(const uint4& v, float* a, float) {
  a[0] = __uint_as_float(v.x);
  a[1] = __uint_as_float(v.y);
  a[2] = __uint_as_float(v.z);
  a[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* a,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[2 * j] = __uint_as_float(w[j] << 16);
    a[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* a, __half) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
    a[2 * j] = f.x;
    a[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* a, float) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                    __float_as_uint(a[2]), __float_as_uint(a[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename H>
__device__ __forceinline__ uint4 pack(const float* a, H) {
  return make_uint4(pack2(a[0], a[1], H()), pack2(a[2], a[3], H()),
                    pack2(a[4], a[5], H()), pack2(a[6], a[7], H()));
}

// An operand of storage type TS laid out by the columns of T.
template <typename TS, typename T, int VPL, bool VEC>
struct Row;

// The vector layout: NG groups of NU raw 16-byte vectors, unpacked to
// float on use.
template <typename TS, typename T, int VPL>
struct Row<TS, T, VPL, true> {
  static constexpr int E = Elems<T>::E;
  static constexpr int PER = Elems<TS>::E;  // values of TS a vector
  static constexpr int NU = E / PER;        // vectors a group: 1 or 2
  static constexpr int NG = VPL / E;
  static_assert(VPL % E == 0, "VPL must be whole groups");
  static_assert(E % PER == 0, "an operand is T or wider");
  uint4 v[NG * NU];

  __device__ __forceinline__ static int col(int k, int lane) {
    return (lane + 32 * (k / E)) * E + k % E;
  }
  __device__ __forceinline__ void load(const TS* p, int D, int lane) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (lane + 32 * i) * E;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        v[i * NU + u] =
            c < D ? __ldg(reinterpret_cast<const uint4*>(p + c) + u)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void get(float (&a)[VPL]) const {
#pragma unroll
    for (int i = 0; i < NG * NU; ++i) unpack(v[i], a + i * PER, TS());
  }
  __device__ __forceinline__ static void store(TS* p, int D, int lane,
                                               const float (&a)[VPL]) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (lane + 32 * i) * E;
      if (c < D) {
#pragma unroll
        for (int u = 0; u < NU; ++u)
          reinterpret_cast<uint4*>(p + c)[u] = pack(a + (i * NU + u) * PER,
                                                    TS());
      }
    }
  }
};

// The element layout: any D, any alignment.
template <typename TS, typename T, int VPL>
struct Row<TS, T, VPL, false> {
  TS v[VPL];

  __device__ __forceinline__ static int col(int k, int lane) {
    return lane + 32 * k;
  }
  __device__ __forceinline__ void load(const TS* p, int D, int lane) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < D ? p[c] : from_f32<TS>(0.f);
    }
  }
  __device__ __forceinline__ void get(float (&a)[VPL]) const {
#pragma unroll
    for (int k = 0; k < VPL; ++k) a[k] = to_f32(v[k]);
  }
  __device__ __forceinline__ static void store(TS* p, int D, int lane,
                                               const float (&a)[VPL]) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = lane + 32 * k;
      if (c < D) p[c] = from_f32<TS>(a[k]);
    }
  }
};

// Forward, vector layout: warp w of W takes rows w, w + W, ...
template <typename T, typename TR, typename TW, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_res_vec_kernel(const T* __restrict__ x, const TR* __restrict__ r,
                  const TW* __restrict__ g, const TW* __restrict__ b,
                  T* __restrict__ s, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int M, int D, float eps) {
  using R = Row<T, T, VPL, true>;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // g and b stay resident, at their own width, for every row of the warp
  Row<TW, T, VPL, true> gr, br;
  R xn;
  Row<TR, T, VPL, true> rn;
  gr.load(g, D, lane);
  br.load(b, D, lane);
  if (row < M) {
    xn.load(x + (size_t)row * D, D, lane);
    rn.load(r + (size_t)row * D, D, lane);
  }
  for (; row < M; row += stride) {
    const size_t base = (size_t)row * D;
    float v[VPL], t[VPL];
    xn.get(v);
    rn.get(t);
    const int next = row + stride;
    if (next < M) {  // in flight under this row's shuffles
      xn.load(x + (size_t)next * D, D, lane);
      rn.load(r + (size_t)next * D, D, lane);
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      v[k] = to_f32(from_f32<T>(v[k] + t[k]));  // slots past D: 0
      sum += v[k];
    }
    R::store(s + base, D, lane, v);  // exact: v holds T values
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      v[k] = R::col(k, lane) < D ? v[k] - mean : 0.f;
      sq += v[k] * v[k];
    }
    const float var = warp_sum(sq) / (float)D;
    const float rstd = 1.f / sqrtf(var + eps);
    float gf[VPL], bf[VPL];
    gr.get(gf);
    br.get(bf);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const float yn = v[k] * rstd;
      v[k] = yn * gf[k] + bf[k];
    }
    R::store(y + base, D, lane, v);
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Backward, one row a warp as the forward walks them, in either layout.
// Each lane keeps its VPL columns' dg / db partial sums in registers; at
// the end the block adds its warps' sums in warp order (shared memory) and
// writes partial row blockIdx.x of part[0] (dg) and part[1] (db), each
// [gridDim.x, D].  No row is loaded ahead: with two sums a value held, the
// registers a second row would need cost more occupancy than they bring
// (measured 0-7% slower at the paths' shapes).  s, dy, ds_out and ds are
// T; g is TW.
template <typename T, typename TW, int VPL, bool VEC, bool HAS_DS>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dy,
              const T* __restrict__ ds_out, const float* __restrict__ mean,
              const float* __restrict__ rstd, const TW* __restrict__ g,
              T* __restrict__ ds, float* __restrict__ part, int M, int D) {
  using R = Row<T, T, VPL, VEC>;
  __shared__ float red[kWarps][2][32 * VPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  float acc_g[VPL], acc_b[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) acc_g[k] = acc_b[k] = 0.f;
  for (int row = blockIdx.x * kWarps + warp; row < M; row += stride) {
    const size_t base = (size_t)row * D;
    R sr, dr, dso;
    Row<TW, T, VPL, VEC> gr;
    sr.load(s + base, D, lane);
    dr.load(dy + base, D, lane);
    gr.load(g, D, lane);  // from L1 after the first row
    if (HAS_DS) dso.load(ds_out + base, D, lane);  // used after the shuffles
    const float m = mean[row], rr = rstd[row];
    float xh[VPL], d[VPL], gf[VPL];
    sr.get(xh);
    dr.get(d);
    gr.get(gf);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      xh[k] = R::col(k, lane) < D ? (xh[k] - m) * rr : 0.f;
      acc_g[k] += d[k] * xh[k];
      acc_b[k] += d[k];
      d[k] *= gf[k];  // dxhat
      s1 += d[k];
      s2 += d[k] * xh[k];
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
    float o[VPL];
    if (HAS_DS) dso.get(o);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const float v = rr * (d[k] - m1 - xh[k] * m2);
      o[k] = HAS_DS ? v + o[k] : v;
    }
    R::store(ds + base, D, lane, o);
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = R::col(k, lane);
    if (c < D) {
      red[warp][0][c] = acc_g[k];
      red[warp][1][c] = acc_b[k];
    }
  }
  __syncthreads();
  const size_t rows = gridDim.x;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float a = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[w][0][c];
      t += red[w][1][c];
    }
    part[(size_t)blockIdx.x * D + c] = a;
    part[(rows + blockIdx.x) * D + c] = t;
  }
}

// dg, db [D] in TW: part[0], part[1] summed over their B rows, per column
// in row order within kRedGroups interleaved groups, then the groups in
// order.
constexpr int kRedGroups = 16;

template <typename TW>
__global__ void __launch_bounds__(32 * kRedGroups)
ln_bwd_reduce_kernel(const float* __restrict__ part, int B, int D,
                     TW* __restrict__ dg, TW* __restrict__ db) {
  __shared__ float red[kRedGroups][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + (size_t)blockIdx.y * B * D;
  float a = 0.f;
  if (c < D)
    for (int i = threadIdx.y; i < B; i += kRedGroups)
      a += p[(size_t)i * D + c];
  red[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRedGroups; ++i) t += red[i][threadIdx.x];
    (blockIdx.y ? db : dg)[c] = from_f32<TW>(t);
  }
}

// ---------------------------------------------------------------------------
// Dtype dispatch.  Codes: 0 float32, 1 bfloat16, 2 float16.  with_types
// calls fn(Tag<T>, Tag<TR>, Tag<TW>) for the (x, r, g / b) codes the kernels
// take, and returns nullptr for any other mix.

template <typename T>
struct Tag {
  using type = T;
};

template <typename T, typename Fn>
const void* with_rw(int code, int rdt, int wdt, Fn fn) {
  if (rdt == code && wdt == code) return fn(Tag<T>(), Tag<T>(), Tag<T>());
  if (rdt == code && wdt == 0) return fn(Tag<T>(), Tag<T>(), Tag<float>());
  if (rdt == 0 && wdt == code) return fn(Tag<T>(), Tag<float>(), Tag<T>());
  if (rdt == 0 && wdt == 0) return fn(Tag<T>(), Tag<float>(), Tag<float>());
  return nullptr;
}

template <typename Fn>
const void* with_types(int dt, int rdt, int wdt, Fn fn) {
  if (dt == 0)
    return rdt == 0 && wdt == 0
               ? fn(Tag<float>(), Tag<float>(), Tag<float>())
               : nullptr;
  if (dt == 1) return with_rw<__nv_bfloat16>(1, rdt, wdt, fn);
  if (dt == 2) return with_rw<__half>(2, rdt, wdt, fn);
  return nullptr;
}

#define LN_TYPES(a, b, c)                  \
  using T = typename decltype(a)::type;    \
  using TR = typename decltype(b)::type;   \
  using TW = typename decltype(c)::type;   \
  (void)sizeof(TR);                        \
  (void)sizeof(TW)

// The kernel of a (dtypes, VPL[, layout, ds_out]) case, or nullptr.
const void* fwd_vec_kernel(int dt, int rdt, int wdt, int vpl) {
  return with_types(dt, rdt, wdt, [vpl](auto a, auto b, auto c) -> const void* {
    LN_TYPES(a, b, c);
    switch (vpl) {
      case 8: return (const void*)ln_res_vec_kernel<T, TR, TW, 8>;
      case 16: return (const void*)ln_res_vec_kernel<T, TR, TW, 16>;
      case 24: return (const void*)ln_res_vec_kernel<T, TR, TW, 24>;
      case 32: return (const void*)ln_res_vec_kernel<T, TR, TW, 32>;
    }
    return nullptr;
  });
}

const void* fwd_first_kernel(int dt, int rdt, int wdt, bool wide) {
  return with_types(dt, rdt, wdt, [wide](auto a, auto b, auto c) -> const void* {
    LN_TYPES(a, b, c);
    return wide ? (const void*)ln_res_wide_kernel<T, TR, TW>
                : (const void*)ln_res_kernel<T, TR, TW, kVPT>;
  });
}

template <typename T, typename TW, bool VEC>
const void* bwd_kernel_l(int vpl, int has_ds) {
  if constexpr (!VEC) {  // one width: the element layout is the rare case
    if (vpl != kMaxVPL) return nullptr;
    return has_ds ? (const void*)ln_bwd_kernel<T, TW, kMaxVPL, false, true>
                  : (const void*)ln_bwd_kernel<T, TW, kMaxVPL, false, false>;
  } else {
    switch (vpl * 2 + (has_ds ? 1 : 0)) {
      case 16: return (const void*)ln_bwd_kernel<T, TW, 8, true, false>;
      case 17: return (const void*)ln_bwd_kernel<T, TW, 8, true, true>;
      case 32: return (const void*)ln_bwd_kernel<T, TW, 16, true, false>;
      case 33: return (const void*)ln_bwd_kernel<T, TW, 16, true, true>;
      case 48: return (const void*)ln_bwd_kernel<T, TW, 24, true, false>;
      case 49: return (const void*)ln_bwd_kernel<T, TW, 24, true, true>;
      case 64: return (const void*)ln_bwd_kernel<T, TW, 32, true, false>;
      case 65: return (const void*)ln_bwd_kernel<T, TW, 32, true, true>;
    }
    return nullptr;
  }
}

// The backward reads no residual: its cases are (T, TW).
const void* bwd_kernel(int dt, int wdt, int vpl, int vec, int has_ds) {
  return with_types(dt, dt, wdt, [=](auto a, auto b, auto c) -> const void* {
    LN_TYPES(a, b, c);
    return vec ? bwd_kernel_l<T, TW, true>(vpl, has_ds)
               : bwd_kernel_l<T, TW, false>(vpl, has_ds);
  });
}

const void* bwd_reduce_kernel(int wdt) {
  if (wdt == 0) return (const void*)ln_bwd_reduce_kernel<float>;
  if (wdt == 1) return (const void*)ln_bwd_reduce_kernel<__nv_bfloat16>;
  if (wdt == 2) return (const void*)ln_bwd_reduce_kernel<__half>;
  return nullptr;
}

bool vpl_fits(int vpl, int D) {
  return vpl % 8 == 0 && vpl <= kMaxVPL && D > 0 && D <= 32 * vpl;
}

int per_vector(int dt) { return dt == 0 ? 4 : 8; }

cudaError_t launch_first(int dt, int rdt, int wdt, bool wide, const void* x,
                         const void* r, const void* g, const void* b,
                         void* s, void* y, void* mean, void* rstd, int M,
                         int D, float eps, cudaStream_t st) {
  const void* fn = fwd_first_kernel(dt, rdt, wdt, wide);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (!wide) {
    void* args[] = {&x, &r, &g, &b, &s, &y, &mean, &rstd, &M, &D, &eps};
    return cudaLaunchKernel(fn, dim3((M + kWarps - 1) / kWarps),
                            dim3(kThreads), args, 0, st);
  }
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  void* args[] = {&x, &r, &g, &b, &s, &y, &mean, &rstd, &D, &eps};
  return cudaLaunchKernel(fn, dim3(M), dim3(kWideThreads), args, smem, st);
}

}  // namespace

// dtype / rdtype / wdtype: the codes of x (and s, y), of r, and of g and b
// (0 = float32, 1 = bfloat16, 2 = float16): x one of the three, r and g / b
// each x's or float32 (all float32 for a float32 x).
// Layouts (all contiguous): x, r, s, y [M, D]; g, b [D]; mean, rstd [M] f32.
// 1 <= D <= 768.  Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t.
extern "C" int layernorm_residual_fwd(int dtype, int rdtype, int wdtype,
                                      const void* x, const void* r,
                                      const void* g, const void* b, void* s,
                                      void* y, void* mean, void* rstd, int M,
                                      int D, float eps, void* stream) {
  if (M <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  return launch_first(dtype, rdtype, wdtype, false, x, r, g, b, s, y, mean,
                      rstd, M, D, eps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* layernorm_residual_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The wide variant: as layernorm_residual_fwd, for 768 < D <= 49152.
extern "C" int layernorm_residual_fwd_wide(int dtype, int rdtype, int wdtype,
                                           const void* x, const void* r,
                                           const void* g, const void* b,
                                           void* s, void* y, void* mean,
                                           void* rstd, int M, int D,
                                           float eps, void* stream) {
  if (M <= 0 || D <= kMaxD || D > kMaxWideD) return cudaErrorInvalidValue;
  return launch_first(dtype, rdtype, wdtype, true, x, r, g, b, s, y, mean,
                      rstd, M, D, eps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* layernorm_residual_fwd_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Resident blocks an SM of a Hopper-design kernel (`which` 0: the forward,
// 1: the backward's row kernel), written to *out; the wrapper sizes its
// persistent grids (and the backward's partial rows) from it.
extern "C" int layernorm_residual_occupancy(int which, int dtype, int rdtype,
                                            int wdtype, int vpl, int vec,
                                            int has_ds, int* out) {
  const void* fn =
      which == 0 ? (vec ? fwd_vec_kernel(dtype, rdtype, wdtype, vpl) : nullptr)
                 : bwd_kernel(dtype, wdtype, vpl, vec, has_ds);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, 0);
}

extern "C" const char* layernorm_residual_occupancy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The Hopper forward: as layernorm_residual_fwd, for D <= 32 * vpl <= 1024,
// D * itemsize of x a multiple of 16 and every pointer 16-byte aligned, on a
// persistent grid of `blocks` 128-thread blocks.
extern "C" int layernorm_residual_fwd_vec(int dtype, int rdtype, int wdtype,
                                          int vpl, const void* x,
                                          const void* r, const void* g,
                                          const void* b, void* s, void* y,
                                          void* mean, void* rstd, int M,
                                          int D, float eps, int blocks,
                                          void* stream) {
  const void* fn = fwd_vec_kernel(dtype, rdtype, wdtype, vpl);
  if (fn == nullptr || M <= 0 || blocks <= 0 || !vpl_fits(vpl, D) ||
      D % per_vector(dtype) != 0)
    return cudaErrorInvalidValue;
  void* args[] = {&x, &r, &g, &b, &s, &y, &mean, &rstd, &M, &D, &eps};
  return cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* layernorm_residual_fwd_vec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward: ds [M, D] (dtype), dg and db [D] (wdtype) from s, dy,
// ds_out (or null; all dtype), g [D] (wdtype) and mean, rstd [M] (f32), all
// contiguous.  D <= 32 * vpl <= 1024; vec = 1 takes the vector layout (D *
// itemsize a multiple of 16, pointers 16-byte aligned), vec = 0 the element
// layout (vpl = 32).  part is float32 workspace [2, blocks, D].  Two
// launches on `stream`: the rows on `blocks` persistent blocks, then the
// column sums.
extern "C" int layernorm_residual_bwd(int dtype, int wdtype, int vpl,
                                      int vec, const void* s, const void* dy,
                                      const void* ds_out, const void* mean,
                                      const void* rstd, const void* g,
                                      void* ds, void* part, void* dg,
                                      void* db, int M, int D, int blocks,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn = bwd_kernel(dtype, wdtype, vpl, vec, ds_out != nullptr);
  const void* red = bwd_reduce_kernel(wdtype);
  if (fn == nullptr || red == nullptr || M <= 0 || blocks <= 0 ||
      !vpl_fits(vpl, D) || (vec && D % per_vector(dtype) != 0))
    return cudaErrorInvalidValue;
  void* args[] = {&s, &dy, &ds_out, &mean, &rstd, &g, &ds, &part, &M, &D};
  cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, 0,
                                   st);
  if (e != cudaSuccess) return e;
  void* rargs[] = {&part, &blocks, &D, &dg, &db};
  return cudaLaunchKernel(red, dim3((D + 31) / 32, 2), dim3(32, kRedGroups),
                          rargs, 0, st);
}

extern "C" const char* layernorm_residual_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
