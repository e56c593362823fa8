// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel paddle_tpu/ops/flash_attention.py
// (_fwd_kernel / _fwd_pallas, public entries flash_attention and
// flash_attention_fwd_lse).  It computes the same function over
// q [BH, S, hd] and k, v [BH, K, hd] (one contiguous slab per batch x head):
//   s[i, j] = (q_i . k_j) * sm_scale in float32;
//   key j is masked (-inf) when j >= K, or, causal, when
//   q_off + i < j (q_off: the global position of q's first row, any value,
//   negative or not block-aligned, as ring attention passes);
//   out_i = sum_j softmax(s_i)_j v_j in q's dtype, lse_i = logsumexp(s_i) in
//   float32; a row with no valid key gives out 0 and lse -inf (the
//   m_safe / alpha guard of the TPU kernel, so a masked row never turns
//   into NaN).
//
// What bounds it on an H100: operations.  A call does 4 * (valid q-k pairs)
// * hd flops on 2 * hd * (S + 2K) bytes of q, k, v, out: at S = K = 8192,
// hd 64 that is ~4000 flops a byte, far above the card's ~295 flop/byte
// ridge in bf16.  The [S, K] score matrix never exists in device memory.
//
// What this first design does about it: one 128-thread block per
// (batch x head, 64-row q tile).  The q tile is staged in shared memory
// once; k and v stream through shared memory one BK-key tile at a time,
// and each tile's scores, the online softmax (running max and sum per row,
// one rescale of the accumulator per tile) and the P.V product stay in
// registers.  bf16: both products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, float32 accumulators), each warp owning 16 q rows;
// the float32 probabilities are rounded to bf16 for the P.V product (the
// TPU kernel multiplies them in float32), v's fragments come transposed
// by ldmatrix.trans.  float32: FMAs on the CUDA cores (TF32 is off by the
// port's rule), each thread owning 4 rows x (BK/8 keys, hd/8 columns).
// Causal tiles wholly above the diagonal are never visited, and the
// blocks of the longest rows start first: the card's analog of the TPU's
// triangle grid, which is a schedule, not semantics.  Shared rows are
// padded so fragment loads hit distinct banks.  Not done yet (later
// work): wgmma, TMA and a producer warp double-buffering k / v, a
// persistent schedule.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // q rows per block
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int S, K;
  long long q_off;
  int causal;
  float scale_log2;  // sm_scale * log2(e): scores kept in base-2 units
};

// Key tiles the q tile starting at row q0 visits: all of them, or, causal,
// those not wholly above the diagonal of its last real row.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int bk) {
  int n = (p.K + bk - 1) / bk;
  if (p.causal) {
    const long long last = p.q_off + min(q0 + kBQ, p.S) - 1;
    if (last < 0) return 0;
    const long long t = last / bk + 1;
    if (t < n) n = (int)t;
  }
  return n;
}

__device__ __forceinline__ bool key_ok(const Params& p, long long qpos,
                                       int key) {
  return key < p.K && (!p.causal || qpos >= key);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
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

// Two transposed 8x8 bf16 tiles: lanes 0-7 address the rows of the first,
// lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Copy rows [r0, r0 + rows) of a [n, HD] bf16 slab into shared rows of
// stride LD, 16 bytes a thread; rows at or past n are zero.
template <int HD, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int rows, int n) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Each warp owns 16 q rows: thread (g = lane / 4, t = lane % 4) holds rows
// g and g + 8 of them, columns 2t, 2t + 1 of every 8-wide accumulator tile
// (the m16n8 fragment layout).
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = HD + 8;  // +16 bytes: fragment loads hit distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.S * HD;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * p.K * HD;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * p.K * HD;

  stage_bf16<HD, LD>(Qs, q, q0, kBQ, p.S);

  const int row0 = warp * 16 + g;  // tile rows row0 and row0 + 8
  const long long qpos[2] = {p.q_off + q0 + row0, p.q_off + q0 + row0 + 8};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_kt = key_tiles(p, q0, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    stage_bf16<HD, LD>(Ks, k, k0, BK, p.K);
    stage_bf16<HD, LD>(Vs, v, k0, BK, p.K);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + row0 * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                             ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], a, ld32(kb), ld32(kb + 8));
      }
    }

    // mask, scale to base 2, row max over the 4 threads of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key_ok(p, qpos[e >> 1], key) ? s[n][e] * p.scale_log2
                                               : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float msafe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      msafe[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - msafe[r]);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - msafe[e >> 1]);
        ls[e >> 1] += s[n][e];
      }
    // per-thread partial row sums; the quad's are added at the end
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P . V: two adjacent score tiles are one A fragment
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vrow = Vs + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(o[n], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.out) + (size_t)bh * p.S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = q0 + row0 + 8 * r;
    if (row >= p.S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * HD + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse[(size_t)bh * p.S + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// Copy rows [r0, r0 + rows) of a [n, HD] float32 slab into shared rows of
// stride LD; rows at or past n are zero.
template <int HD, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int rows, int n) {
  constexpr int CH = HD / 4;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * HD + c);
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// Thread (rg = tid / 8, cg = tid % 8) owns tile rows 4 rg .. 4 rg + 3, keys
// cg + 8 j of each tile and output columns cg + 8 j; the 8 threads sharing
// a row are neighbouring lanes of one warp.
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Params p) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDP = BK + 2;  // bank padding
  constexpr int NJ = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][LDQ]
  float* Ks = Qs + kBQ * LDQ;                      // [BK][LDK]
  float* Vs = Ks + BK * LDK;                       // [BK][HD]
  float* Ps = Vs + BK * HD;                        // [kBQ][LDP]

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.S * HD;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.K * HD;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.K * HD;

  stage_f32<HD, LDQ>(Qs, q, q0, kBQ, p.S);

  float o[4][ND];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[i][j] = 0.f;
  }

  const int n_kt = key_tiles(p, q0, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage_f32<HD, LDK>(Ks, k, k0, BK, p.K);
    stage_f32<HD, HD>(Vs, v, k0, BK, p.K);
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[(cg + 8 * j) * LDK + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = p.q_off + q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = key_ok(p, qpos, k0 + cg + 8 * j) ? s[i][j] * p.scale_log2
                                                   : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float msafe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : exp2f(m[i] - msafe);
      m[i] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pj = exp2f(s[i][j] - msafe);
        Ps[(rg * 4 + i) * LDP + cg + 8 * j] = pj;
        ls += pj;
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[i][j] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from lanes of this warp

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * LDP + key];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = Vs[key * HD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

  float* out = static_cast<float*>(p.out) + (size_t)bh * p.S * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    l[i] += __shfl_xor_sync(kFull, l[i], 4);
    const int row = q0 + rg * 4 + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      out[(size_t)row * HD + cg + 8 * j] = l[i] > 0.f ? o[i][j] / l[i] : 0.f;
    if (cg == 0)
      p.lse[(size_t)bh * p.S + row] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -INFINITY;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, int BH,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int BK>
cudaError_t launch_bf16(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = (size_t)(kBQ + 2 * BK) * (HD + 8) * 2;
  return launch(flash_fwd_bf16_kernel<HD, BK>, smem, p, BH, s);
}

template <int HD, int BK>
cudaError_t launch_f32(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = ((size_t)kBQ * (HD + 1) + (size_t)BK * (HD + 1) +
                       (size_t)BK * HD + (size_t)kBQ * (BK + 2)) * 4;
  return launch(flash_fwd_f32_kernel<HD, BK>, smem, p, BH, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Layouts (all contiguous, 16-byte aligned): q/out [BH, S, hd];
// k/v [BH, K, hd]; lse [BH, S] float32.  hd in {64, 128, 256}; S >= 1,
// K >= 0; q_off any value.  Launches on `stream`, does not synchronise,
// returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int BH, int S, int K, int hd,
                                   long long q_off, int causal,
                                   float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || K < 0) return cudaErrorInvalidValue;
  Params p{q, k, v, out, static_cast<float*>(lse), S, K, q_off,
           causal ? 1 : 0, sm_scale * kLog2e};
  if (dtype == 1) {
    if (hd == 64) return launch_bf16<64, 64>(p, BH, st);
    if (hd == 128) return launch_bf16<128, 64>(p, BH, st);
    if (hd == 256) return launch_bf16<256, 32>(p, BH, st);
  } else if (dtype == 0) {
    if (hd == 64) return launch_f32<64, 64>(p, BH, st);
    if (hd == 128) return launch_f32<128, 64>(p, BH, st);
    if (hd == 256) return launch_f32<256, 32>(p, BH, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
