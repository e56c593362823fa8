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
// ridge in bf16, so the goal is the tensor cores' rate: 989 TFLOP/s bf16,
// reached only through wgmma.  The [S, K] score matrix never exists in
// device memory.
//
// What the design does about it.  bf16 (the long-context path):
//   * one block per (batch x head, 128-row q tile): two consumer
//     warpgroups of 64 q rows share every k / v tile, so each byte of k
//     and v read serves 128 rows;
//   * k / v reach shared memory through a ring of stages filled by TMA
//     (cp.async.bulk.tensor, one tensor map per operand and call, built on
//     the host with libcuda's cuTensorMapEncodeTiled) from one thread
//     of a producer warpgroup, with a full / empty mbarrier pair a stage:
//     tile j + 1 lands while tile j is multiplied, and the consumers issue
//     no load;
//   * s = q . k^T is a wgmma with both operands in shared memory (K-major,
//     as hd is contiguous) and o += p . v a wgmma with p from registers
//     (the float32 probabilities rounded to bf16, as the first design did;
//     the TPU kernel multiplies them in float32) and v in shared memory,
//     MN-major through the transpose bit.  The shared layouts are TMA's
//     128-byte swizzle, which the wgmma descriptors name: [hd / 64] atoms
//     of 64 columns, 128-byte rows, 8-row groups 1024 bytes apart;
//   * the online softmax (running max and sum per row, one rescale of the
//     accumulator per tile) stays in registers, in wgmma's accumulator
//     layout, and is software-pipelined as in FlashAttention-3: tile
//     j + 1's s = q . k^T is issued before tile j's o += p . v, and its
//     softmax runs while that product is still in flight;
//   * exponentials on the SFU's ex2.approx.ftz (a p below 2^-126 of its
//     row's largest is 0; exp2f's subnormal handling cost 15% at hd 64,
//     where the SFU's rate, not the tensor cores', bounds the softmax);
//   * setmaxnreg moves registers from the producer warpgroup (40 a
//     thread) to the consumers (232): o, s and p of a 64-row warpgroup;
//   * key tiles (shared memory of 227 KB): 128 keys at hd 64 (q 16 KB,
//     3 stages of 32 KB) and hd 128 (q 32 KB, 2 stages of 64 KB); 32 keys
//     at hd 256 (q 64 KB, 3 stages of 32 KB), where o alone is 128
//     registers a thread.
// Built in steps, each timed at the slice's shape [2, 12, 8192, 64] bf16
// causal on an H100 in one call (tools/torch_kernel_ab.py; PERF.md
// section 6): the first design (64-row tiles, 4 warps, synchronous
// staging, mma.sync m16n8k16) 1.35 ms; 128-row tiles on a two-stage
// cp.async ring, still mma.sync, 1.24 ms; wgmma on the TMA ring with the
// register hand-over 0.77 ms; the pipelined softmax 0.72 ms;
// ex2.approx.ftz 0.60 ms.
// float32 (the parity route): one 128-thread block per 64-row q tile, k
// and v staged through padded shared rows, FMAs on the CUDA cores (TF32 is
// off by the port's rule), each thread owning 4 rows x (BK / 8 keys,
// hd / 8 columns).
// Both: causal tiles wholly above the diagonal are never visited, and the
// blocks of the longest rows start first: the card's analog of the TPU's
// triangle grid, which is a schedule, not semantics.  Not done yet (later
// work): a persistent schedule, 192-row tiles at hd 64.  The warpgroups
// do not take turns to issue (named-barrier ping-pong measured slower).
//
// The mbarrier, TMA, wgmma and tensor-map helpers are in hopper_sm90.cuh,
// shared with the backward kernels (flash_attention_bwd.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C entry,
// bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 64;                 // q rows per block, float32
constexpr int kThreads = 128;           // threads per block, float32
constexpr int kBQ16 = 128;              // q rows per block, bf16
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
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int bq,
                                         int bk) {
  int n = (p.K + bk - 1) / bk;
  if (p.causal) {
    const long long last = p.q_off + min(q0 + bq, p.S) - 1;
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
// bf16: wgmma on a TMA ring
// ---------------------------------------------------------------------------
// The consumer warpgroups of flash_fwd_bf16_kernel: q0's 128 rows against
// the n_kt key tiles of the ring, software-pipelined as FlashAttention-3
// does within a warpgroup: tile j + 1's s = q . k^T is issued, o is
// rescaled for tile j and tile j's o += p . v issued; tile j + 1's softmax
// runs once its scores land, while p . v is still in flight, and its p is
// packed once p . v is done.
template <int HD, int BK, int ST>
__device__ __forceinline__ void consume(const Params& p,
                                        const unsigned char* Qs,
                                        const unsigned char* Ring,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* qbar, int q0, int n_kt) {
  constexpr int KV_BYTES = BK * HD * 2;     // one of k, v in a stage
  constexpr int ON = HD > 128 ? 128 : HD;   // columns of one P.V wgmma
  constexpr int OH = HD / ON;
  const int bh = blockIdx.y;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // tile rows row0 and row0 + 8
  const long long qpos[2] = {p.q_off + q0 + row0, p.q_off + q0 + row0 + 8};
  float o[OH][ON / 2];
#pragma unroll
  for (int h = 0; h < OH; ++h)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) o[h][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const unsigned char* qa = Qs + wg * 64 * 128;  // this warpgroup's rows

  // s = q . k^T for tile j: hd / 16 k-steps, each 32 bytes further into an
  // atom; issued, not waited for
  float s[BK / 2];
  auto issue_s = [&](int j) {
    const unsigned char* kb = Ring + (j % ST) * 2 * KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(s,
                   sw128_desc(qa + (kk >> 2) * kBQ16 * 128 + (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(kb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
  };

  // tile j's softmax on s: mask (key k0 + c is valid for row r when
  // c < lim[r]: before K and, causal, at or before the row's position),
  // scale to base 2, running max and sum, p = exp2 in place; alpha
  // rescales o
  float alpha[2];
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long L = p.K - k0;
      if (p.causal && qpos[r] - k0 + 1 < L) L = qpos[r] - k0 + 1;
      lim[r] = (int)(L < 0 ? 0 : L > BK ? BK : L);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x = n * 8 + 2 * t + (e & 1) < lim[e >> 1] ? x * p.scale_log2
                                                   : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      msafe[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = m[r] == -INFINITY ? 0.f : ex2(m[r] - msafe[r]);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(s[i] - msafe[(i >> 1) & 1]);
      ls[(i >> 1) & 1] += s[i];
    }
    // per-thread partial row sums; the quad's are added at the end
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
  };

  // p of the tile whose p . v is next, the register A operand (two
  // adjacent 8-key blocks a k-step)
  uint32_t pf[BK / 16][4];
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  mbar_wait(qbar, 0);
  if (n_kt > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    softmax(0);
    pack();
  }
  // o += p . v for tile j: v MN-major, 16 keys (2048 bytes) a k-step, ON
  // columns (ON / 64 atoms, BK * 128 bytes apart) a wgmma; o is rescaled
  // for the tile first
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int h = 0; h < OH; ++h)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) o[h][i] *= alpha[(i >> 1) & 1];
    const unsigned char* vb = Ring + (j % ST) * 2 * KV_BYTES + KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < OH; ++h)
        wgmma_rs<ON>(o[h], pf[kk],
                     sw128_desc(vb + h * (ON / 64) * BK * 128 + kk * 2048,
                                BK * 128, 1024));
    wgmma_commit();
  };
  auto retire_pv = [&](int j) {
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < OH; ++h) reg_fence(o[h]);
    reg_fence(pf);
    mbar_arrive(&empty[j % ST]);  // this thread is done with tile j's stage
  };
  // the steady state, every tile but the last: no branch between a
  // product's issue and its wait, so the compiler can keep both in flight
  for (int j = 0; j + 1 < n_kt; ++j) {
    mbar_wait(&full[(j + 1) % ST], ((j + 1) / ST) & 1);
    wgmma_fence();
    issue_s(j + 1);
    wgmma_commit();
    issue_pv(j);
    wgmma_wait<1>();  // tile j + 1's scores; tile j's p . v may still run
    reg_fence(s);
    softmax(j + 1);
    retire_pv(j);
    pack();
  }
  if (n_kt > 0) {
    issue_pv(n_kt - 1);
    retire_pv(n_kt - 1);
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
    for (int h = 0; h < OH; ++h)
#pragma unroll
      for (int n = 0; n < ON / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * HD + h * ON + n * 8 +
                                     2 * t) =
            pack_bf16(o[h][4 * n + 2 * r] * inv, o[h][4 * n + 2 * r + 1] * inv);
    if (t == 0)
      p.lse[(size_t)bh * p.S + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
  }
}

// Shared memory (1024-byte aligned, the swizzle's period): q as
// [HD / 64][128 rows][64] (a 64-column atom of 128-byte rows, as TMA's
// 128-byte swizzle writes it), then ST stages of k and v, each
// [HD / 64][BK][64], then the barriers.  Warps 0-7 are two consumer
// warpgroups of 64 q rows; warpgroup 2 is the producer: one thread keeps
// the ring full with TMA, and the warpgroup hands its registers to the
// consumers (setmaxnreg).  A consumer thread (g = lane / 4, t = lane % 4) of
// warp w holds rows 16 w + g and + 8, columns 8 j + 2 t, + 1 of every
// accumulator (wgmma's m64nN layout, one warp's 16 rows the m16n8 one).
template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, Params p) {
  constexpr int NA = HD / 64;               // 128-byte atoms along hd
  constexpr int Q_BYTES = kBQ16 * HD * 2;
  constexpr int KV_BYTES = BK * HD * 2;     // one of k, v in a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_1024(smem_raw);
  unsigned char* Ring = Qs + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ring + ST * 2 * KV_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ16;
  const int n_kt = key_tiles(p, q0, kBQ16, BK);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    producer_regs();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int a = 0; a < NA; ++a)
        tma_load(Qs + a * kBQ16 * 128, &tq, qbar, 64 * a, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(&empty[st], (j / ST - 1) & 1);
        mbar_expect_tx(&full[st], 2 * KV_BYTES);
        unsigned char* kd = Ring + st * 2 * KV_BYTES;
        for (int a = 0; a < NA; ++a) {
          tma_load(kd + a * BK * 128, &tk, &full[st], 64 * a, j * BK, bh);
          tma_load(kd + KV_BYTES + a * BK * 128, &tv, &full[st], 64 * a,
                   j * BK, bh);
        }
      }
    }
  } else {
    consumer_regs();
    consume<HD, BK, ST>(p, Qs, Ring, full, empty, qbar, q0, n_kt);
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

  const int n_kt = key_tiles(p, q0, kBQ, BK);
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
cudaError_t launch(Kernel kernel, size_t smem, int bq, int threads,
                   const Params& p, int BH, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S + bq - 1) / bq, BH);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int BK, int ST>
cudaError_t launch_bf16(const Params& p, int BH, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  // no key: the k / v maps are never read, but must describe real memory
  const bool keys = p.K > 0;
  cudaError_t e = tensor_map(&tq, p.q, BH, p.S, HD, kBQ16);
  if (e == cudaSuccess)
    e = tensor_map(&tk, keys ? p.k : p.q, BH, keys ? p.K : p.S, HD, BK);
  if (e == cudaSuccess)
    e = tensor_map(&tv, keys ? p.v : p.q, BH, keys ? p.K : p.S, HD, BK);
  if (e != cudaSuccess) return e;
  const size_t smem = 1024 + (size_t)kBQ16 * HD * 2 +
                      (size_t)ST * 2 * BK * HD * 2 + (2 * ST + 1) * 8;
  auto kernel = flash_fwd_bf16_kernel<HD, BK, ST>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBQ16 - 1) / kBQ16, BH);
  kernel<<<grid, kThreadsWg, smem, s>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD, int BK>
cudaError_t launch_f32(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = ((size_t)kBQ * (HD + 1) + (size_t)BK * (HD + 1) +
                       (size_t)BK * HD + (size_t)kBQ * (BK + 2)) * 4;
  return launch(flash_fwd_f32_kernel<HD, BK>, smem, kBQ, kThreads, p, BH,
                s);
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
    if (hd == 64) return launch_bf16<64, 128, 3>(p, BH, st);
    if (hd == 128) return launch_bf16<128, 128, 2>(p, BH, st);
    if (hd == 256) return launch_bf16<256, 32, 3>(p, BH, st);
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
