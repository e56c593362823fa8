// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk / dv kernel.
//
// Replaces: the Pallas TPU kernels of paddle_tpu/ops/flash_attention.py,
// _bwd_dq (body _bwd_dq_kernel) and _bwd_dkv (body _bwd_dkv_kernel), reached
// through flash_attention's custom VJP and flash_attention_bwd_chunk.  Over
// q, dO [BH, S, hd] and k, v [BH, K, hd] (one contiguous slab per batch x
// head), with the forward's lse and delta = rowsum(dO . O) as float32
// [BH, S], they compute the flash-2 recurrence:
//   s[i, j] = (q_i . k_j) * sm_scale in float32, key j masked when j >= K
//   or, causal, when q_off + i < j (any q_off: negative, not block-aligned);
//   p = exp(s - lse_i), with an lse of -inf counted as 0, so a row with no
//   valid key has p = 0 and contributes exactly nothing;
//   dp = dO . v^T;  ds = p * (dp - delta_i) * sm_scale;
//   dq = ds . k (q's dtype);  dk = ds^T . q, dv = p^T . dO (k's dtype).
// Each kernel owns its output tile outright — the dq kernel a q tile, the
// dk / dv kernel a kv tile — as the TPU kernels do: no atomics, every sum
// in a fixed order, so two runs give the same bits.  Ragged S and K are
// masked here (TMA's zero rows past the tensor, zero-filled shared rows,
// the masks above); the host never pads.
//
// What bounds them on an H100: operations.  Per valid (q, key) pair the dq
// kernel does 6 * hd flops (q.k^T, dO.v^T, ds.k) and the dk / dv kernel
// 8 * hd (k.q^T, v.dO^T, p^T.dO, ds^T.q); at S = K = 8192, hd 64, causal
// that is ~4000 flops a byte of q, k, v, dO, dq / dk / dv, far above the
// card's ~295 flop/byte ridge in bf16, so the goal is the tensor cores'
// 989 TFLOP/s, reached only through wgmma.  The score matrix never exists
// in device memory.  Two kernels recompute s and dp: 14 * hd flops a pair
// against a fused backward's 10 * hd, whose dq needs atomics.
//
// What the design does about it.  bf16, kernel 4's machinery
// (hopper_sm90.cuh): a block of two consumer warpgroups of 64 rows and a
// producer warpgroup (setmaxnreg 40 / 232), one thread of which fills a
// ring of shared-memory stages by TMA under the 128-byte swizzle, with a
// full / empty mbarrier pair a stage.
// * dq (every head dim): one block per (batch x head, 128-row q tile), the
//   longest rows first; q and dO of the 128 rows resident, k / v tiles of
//   BK keys streamed up to the causal bound; lse and delta of a thread's
//   two rows in registers.  s = q . k^T and dp = dO . v^T are wgmma with
//   both operands in shared memory (K-major); p and ds are computed in the
//   accumulator registers; dq += ds . k is a wgmma with ds from registers
//   (kernel 4's p hand-over) and k MN-major through the transpose bit (the
//   same stage as s's K-major k).  At hd 128 pipelined as kernel 4: tile
//   j + 1's two score products are issued before tile j's ds . k, whose p
//   and ds run under it, the last tile peeled so the loop has no branch
//   between a product's issue and its wait; at hd 64 and 256 one tile at
//   a time, which measured as fast or faster there.  BK: 128 keys at hd
//   64 (3 stages), 64 at hd 128 (3), 32 at hd 256 (3: q and dO take 128
//   KB).
// * dk / dv (hd 64 and 128): one block per (batch x head, 128-key tile),
//   the first key tiles (the most q tiles, causal) first; k and v
//   resident, q / dO tiles of BQ rows streamed from the first tile
//   holding a row that sees a key of the block: 128 rows at hd 64 (2
//   stages), 64 at hd 128 (3).  s^T = k . q^T and dp^T = v . dO^T are
//   two wgmma commit groups (K-major); p^T is computed while dp^T's
//   product runs, then ds^T; dv += p^T . dO and dk += ds^T . q take p^T
//   and ds^T from registers and dO, q MN-major: nothing is staged through
//   shared memory.  An accumulator column is a q row, so lse and
//   delta are read per column from the stage; they are float32 rows of S
//   floats, not 16-byte aligned for ragged S, so a second producer warp
//   fills them with plain loads and its 32 lanes arrive on the stage's
//   full barrier beside the TMA thread.
// * exponentials on the SFU's ex2.approx.ftz (p below 2^-126 is 0).
// Built in steps, each timed in one call (tools/torch_kernel_ab.py; PERF.md
// section 6) at the slice's shape [2, 12, 8192, 64] bf16 causal on an H100,
// dq / dk-dv: the first design (64-row / 64-key tiles of 4 warps,
// synchronous staging, mma.sync m16n8k16) 1.77 / 2.60 ms; wgmma on the TMA
// ring, no overlap, exp2f 0.89 / 1.00; ex2.approx.ftz 0.69 / 0.91; the
// overlaps above 0.65 / 0.84.
// Where bf16 rounds: the TPU multiplies in float32; here p and ds are
// rounded to bf16 where they enter the tensor cores, and the outputs to
// bf16 once.
// What stays on the first design: bf16 dk / dv at hd 256 — dk and
// dv alone would take 256 float32 registers a thread in a 64-key
// warpgroup — keeps mma.sync m16n8k16 with synchronous staging: 64-key
// blocks of 256 threads, two warps on each 16 keys, each accumulating half
// of the columns (both recompute s^T and dp^T).  float32 inputs take a
// SIMT path on the CUDA cores (TF32 is off by the port's rule): per-thread
// register tiles, ds (and p) staged in shared memory rows that only the
// owning warp reads.
// Not done yet (later work): a persistent schedule; the fused single
// backward, which needs ordered dq accumulation to stay deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C
// entries, bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // q rows of a dq block, float32
constexpr int kBK = 64;  // keys of a dk / dv block, bf16 at hd 256

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int S, K;
  long long q_off;
  int causal;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): scores in base-2 units
};

__device__ __forceinline__ bool pair_ok(const Params& p, int row, int key) {
  return row < p.S && key < p.K && (!p.causal || p.q_off + row >= key);
}

// lse of one row of this slab in base-2 units; 0 for a row with no valid
// key (-inf) and for a row past S (all its pairs are masked anyway)
__device__ __forceinline__ float lse2_of(const Params& p, const float* lse,
                                         int row) {
  if (row >= p.S) return 0.f;
  const float l = lse[row];
  return l == -INFINITY ? 0.f : l * kLog2e;
}

__device__ __forceinline__ float delta_of(const Params& p, const float* delta,
                                          int row) {
  return row < p.S ? delta[row] : 0.f;
}

// Key tiles of BK keys the q tile [q0, q0 + bq) visits: all of them, or,
// causal, those not wholly above the diagonal of its last real row.
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

// The first q tile of bq rows holding a row that sees key k0 (causal: row
// >= k0 - q_off), clamped to n_qt.
__device__ __forceinline__ int first_q_tile(const Params& p, int k0, int bq,
                                            int n_qt) {
  if (!p.causal) return 0;
  const long long r = (long long)k0 - p.q_off;
  if (r <= 0) return 0;
  const long long t = r / bq;
  return t < n_qt ? (int)t : n_qt;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on a TMA ring (dq at every head dim, dk / dv at 64 and 128)
// ---------------------------------------------------------------------------
constexpr int kRows = 128;  // q rows of a dq block, keys of a dk / dv block

// The consumer warpgroups of flash_bwd_dq_wgmma_kernel: q0's 128 rows (64
// a warpgroup) against the n_kt key tiles of the ring.  Per tile: s = q .
// k^T and dp = dO . v^T (both operands K-major in shared memory), p and ds
// in the accumulator registers, dq += ds . k (ds from registers, k
// MN-major: the same stage read through the transpose bit).  PIPE: as
// kernel 4, tile j + 1's two score products are issued before tile j's
// ds . k, and tile j + 1's p and ds are computed while that product runs
// (faster at hd 128, slower at hd 64, even at hd 256: PERF.md section 6).
template <int HD, int BK, int ST, bool PIPE>
__device__ __forceinline__ void dq_consume(const Params& p,
                                           const unsigned char* Qs,
                                           const unsigned char* Os,
                                           const unsigned char* Ring,
                                           uint64_t* full, uint64_t* empty,
                                           uint64_t* qbar, int q0, int n_kt) {
  constexpr int KV_BYTES = BK * HD * 2;    // one of k, v in a stage
  constexpr int ON = HD > 128 ? 128 : HD;  // columns of one ds . k wgmma
  constexpr int OH = HD / ON;
  const int bh = blockIdx.y;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // tile rows row0 and row0 + 8
  const int rows[2] = {q0 + row0, q0 + row0 + 8};
  const float* lse = p.lse + (size_t)bh * p.S;
  const float* delta = p.delta + (size_t)bh * p.S;
  const float l2[2] = {lse2_of(p, lse, rows[0]), lse2_of(p, lse, rows[1])};
  const float dl[2] = {delta_of(p, delta, rows[0]),
                       delta_of(p, delta, rows[1])};
  float dq[OH][ON / 2];
#pragma unroll
  for (int h = 0; h < OH; ++h)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) dq[h][i] = 0.f;
  const unsigned char* qa = Qs + wg * 64 * 128;  // this warpgroup's rows
  const unsigned char* oa = Os + wg * 64 * 128;

  // s = q . k^T and dp = dO . v^T for tile j, one commit group: hd / 16
  // k-steps each, 32 bytes further into an atom a step
  float s[BK / 2], dp[BK / 2];
  auto issue_sdp = [&](int j) {
    const unsigned char* kb = Ring + (j % ST) * 2 * KV_BYTES;
    const unsigned char* vb = kb + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(s,
                   sw128_desc(qa + (kk >> 2) * kRows * 128 + (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(kb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(dp,
                   sw128_desc(oa + (kk >> 2) * kRows * 128 + (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(vb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
  };

  // tile j's p = 2^(s scale_log2 - lse2) on the valid pairs (key k0 + c is
  // valid for row r when c < lim[r]: a real row, a key before K and,
  // causal, at or before the row's position) and ds = p (dp - delta)
  // sm_scale, in place in s
  auto grad = [&](int j) {
    const int k0 = j * BK;
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long L = p.K - k0;
      const long long d = p.q_off + rows[r] - k0 + 1;
      if (p.causal && d < L) L = d;
      if (rows[r] >= p.S) L = 0;
      lim[r] = (int)(L < 0 ? 0 : L > BK ? BK : L);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e, r = e >> 1;
        const float pv = n * 8 + 2 * t + (e & 1) < lim[r]
                             ? ex2(s[i] * p.scale_log2 - l2[r])
                             : 0.f;
        s[i] = pv * (dp[i] - dl[r]) * p.scale;
      }
  };

  // ds of the tile whose ds . k is next, the register A operand (two
  // adjacent 8-key blocks a k-step), rounded to bf16
  uint32_t df[BK / 16][4];
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        df[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  // dq += ds . k for tile j: k MN-major, 16 keys (2048 bytes) a k-step, ON
  // columns (ON / 64 atoms, BK * 128 bytes apart) a wgmma
  auto issue_dq = [&](int j) {
    const unsigned char* kb = Ring + (j % ST) * 2 * KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < OH; ++h)
        wgmma_rs<ON>(dq[h], df[kk],
                     sw128_desc(kb + h * (ON / 64) * BK * 128 + kk * 2048,
                                BK * 128, 1024));
    wgmma_commit();
  };
  auto retire_dq = [&](int j) {
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < OH; ++h) reg_fence(dq[h]);
    reg_fence(df);
    mbar_arrive(&empty[j % ST]);  // this thread is done with tile j's stage
  };

  mbar_wait(qbar, 0);
  if constexpr (!PIPE) {
    for (int j = 0; j < n_kt; ++j) {
      mbar_wait(&full[j % ST], (j / ST) & 1);
      wgmma_fence();
      issue_sdp(j);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      grad(j);
      pack();
      issue_dq(j);
      retire_dq(j);
    }
  } else {
    if (n_kt > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_sdp(0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      grad(0);
      pack();
    }
    // the steady state, every tile but the last: no branch between a
    // product's issue and its wait
    for (int j = 0; j + 1 < n_kt; ++j) {
      mbar_wait(&full[(j + 1) % ST], ((j + 1) / ST) & 1);
      wgmma_fence();
      issue_sdp(j + 1);
      wgmma_commit();
      issue_dq(j);
      wgmma_wait<1>();  // tile j + 1's scores; tile j's ds . k may still run
      reg_fence(s);
      reg_fence(dp);
      grad(j + 1);
      retire_dq(j);
      pack();
    }
    if (n_kt > 0) {
      issue_dq(n_kt - 1);
      retire_dq(n_kt - 1);
    }
  }

  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.S) continue;
#pragma unroll
    for (int h = 0; h < OH; ++h)
#pragma unroll
      for (int n = 0; n < ON / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + (size_t)rows[r] * HD + h * ON +
                                     n * 8 + 2 * t) =
            pack_bf16(dq[h][4 * n + 2 * r], dq[h][4 * n + 2 * r + 1]);
  }
}

// dq, bf16.  Shared memory (1024-byte aligned): q and dO of the block's
// 128 rows, each [HD / 64][128][64] as TMA's 128-byte swizzle writes it,
// then ST stages of k and v, each [HD / 64][BK][64], then the barriers.
// Warps 0-7 are two consumer warpgroups of 64 q rows; warpgroup 2 is the
// producer: one thread loads q and dO once and keeps the k / v ring full.
template <int HD, int BK, int ST, bool PIPE>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Params p) {
  constexpr int NA = HD / 64;  // 128-byte atoms along hd
  constexpr int Q_BYTES = kRows * HD * 2;
  constexpr int KV_BYTES = BK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_1024(smem_raw);
  unsigned char* Os = Qs + Q_BYTES;
  unsigned char* Ring = Os + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ring + ST * 2 * KV_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRows;
  const int n_kt = key_tiles(p, q0, kRows, BK);
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
      mbar_expect_tx(qbar, 2 * Q_BYTES);
      for (int a = 0; a < NA; ++a) {
        tma_load(Qs + a * kRows * 128, &tq, qbar, 64 * a, q0, bh);
        tma_load(Os + a * kRows * 128, &tdo, qbar, 64 * a, q0, bh);
      }
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
    dq_consume<HD, BK, ST, PIPE>(p, Qs, Os, Ring, full, empty, qbar, q0,
                                 n_kt);
  }
}

// The consumer warpgroups of flash_bwd_dkv_wgmma_kernel: the block's 128
// keys (64 a warpgroup) against the n_qt streamed q tiles from tile qt0.
// Per tile: s^T = k . q^T and dp^T = v . dO^T (both operands K-major) in
// two commit groups, p^T computed while dp^T's product runs, then ds^T;
// dv += p^T . dO and dk += ds^T . q with p^T and ds^T from registers and
// dO, q MN-major.  An accumulator column is a q row: its lse (base 2) and
// delta come from the stage.  (Issuing tile j + 1's score products before
// tile j's dv / dk products, as dq does, measured no faster at hd 64 and
// slower at hd 128, where ptxas serializes it for want of registers.)
template <int HD, int BQ, int ST>
__device__ __forceinline__ void dkv_consume(const Params& p,
                                            const unsigned char* Ks,
                                            const unsigned char* Vs,
                                            const unsigned char* Ring,
                                            const float* Stats,
                                            uint64_t* full, uint64_t* empty,
                                            uint64_t* kvbar, int k0, int qt0,
                                            int n_qt) {
  constexpr int Q_BYTES = BQ * HD * 2;  // one of q, dO in a stage
  const int bh = blockIdx.y;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const unsigned char* ka = Ks + wg * 64 * 128;  // this warpgroup's keys
  const unsigned char* va = Vs + wg * 64 * 128;
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];

  auto issue_s = [&](int j) {
    const unsigned char* qb = Ring + (j % ST) * 2 * Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BQ>(s,
                   sw128_desc(ka + (kk >> 2) * kRows * 128 + (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(qb + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
  };
  auto issue_dp = [&](int j) {
    const unsigned char* ob = Ring + (j % ST) * 2 * Q_BYTES + Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BQ>(dp,
                   sw128_desc(va + (kk >> 2) * kRows * 128 + (kk & 3) * 32,
                              16, 1024),
                   sw128_desc(ob + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
  };
  // p^T in place in s: column c (q row r0 + c) is valid for key r when
  // lo[r] <= c < hi: a real row, a real key and, causal, a row at or after
  // the key
  auto grad_p = [&](int j) {
    const float* L2s = Stats + (j % ST) * 2 * BQ;
    const int r0 = (qt0 + j) * BQ;
    const int hi = p.S - r0 < BQ ? p.S - r0 : BQ;
    int lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long L = p.causal ? (long long)keys[r] - p.q_off - r0 : 0;
      if (keys[r] >= p.K) L = BQ;
      lo[r] = (int)(L < 0 ? 0 : L > BQ ? BQ : L);
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(L2s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float x = s[4 * n + e] * p.scale_log2 - ((e & 1) ? l2.y : l2.x);
        s[4 * n + e] = c >= lo[e >> 1] && c < hi ? ex2(x) : 0.f;
      }
    }
  };
  // ds^T = p^T (dp^T - delta) sm_scale in place in dp
  auto grad_ds = [&](int j) {
    const float* Ds = Stats + (j % ST) * 2 * BQ + BQ;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(Ds + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        dp[i] = s[i] * (dp[i] - ((e & 1) ? d.y : d.x)) * p.scale;
      }
    }
  };
  // the register A operands of the next dv / dk products, rounded to bf16
  auto pack = [&](uint32_t (&f)[BQ / 16][4], const float (&x)[BQ / 2]) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  };
  // dv += p^T . dO, dk += ds^T . q: 16 q rows (2048 bytes) a k-step, HD
  // columns (HD / 64 atoms, BQ * 128 bytes apart) a wgmma; one group
  auto issue_kv = [&](int j) {
    const unsigned char* qb = Ring + (j % ST) * 2 * Q_BYTES;
    const unsigned char* ob = qb + Q_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<HD>(dv, pf[kk], sw128_desc(ob + kk * 2048, BQ * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<HD>(dk, df[kk], sw128_desc(qb + kk * 2048, BQ * 128, 1024));
    wgmma_commit();
  };
  auto retire_kv = [&](int j) {
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pf);
    reg_fence(df);
    mbar_arrive(&empty[j % ST]);  // this thread is done with the stage
  };

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_qt; ++j) {
    mbar_wait(&full[j % ST], (j / ST) & 1);
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    issue_dp(j);
    wgmma_commit();
    wgmma_wait<1>();  // s^T landed; dp^T's product may still run
    reg_fence(s);
    grad_p(j);
    pack(pf, s);
    wgmma_wait<0>();
    reg_fence(dp);
    grad_ds(j);
    pack(df, dp);
    issue_kv(j);
    retire_kv(j);
  }

  __nv_bfloat16* dkp =
      static_cast<__nv_bfloat16*>(p.dk) + (size_t)bh * p.K * HD;
  __nv_bfloat16* dvp =
      static_cast<__nv_bfloat16*>(p.dv) + (size_t)bh * p.K * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.K) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const size_t o = (size_t)keys[r] * HD + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + o) =
          pack_bf16(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvp + o) =
          pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

// dk / dv, bf16.  Shared memory (1024-byte aligned): k and v of the
// block's 128 keys, each [HD / 64][128][64], then ST stages of q and dO,
// each [HD / 64][BQ][64], then ST stages of the rows' lse (base 2) and
// delta, [2][BQ] floats, then the barriers.  Warps 0-7 are two consumer
// warpgroups of 64 keys; in the producer warpgroup one thread loads k and
// v once and keeps the q / dO ring full by TMA, and warp 1 fills each
// stage's lse and delta with plain loads (a row of S floats is not 16-byte
// aligned for ragged S, so TMA cannot take it): a stage's full barrier
// waits for that thread and the warp's 32 lanes.
template <int HD, int BQ, int ST>
__global__ void __launch_bounds__(kThreadsWg, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Params p) {
  constexpr int NA = HD / 64;
  constexpr int KV_BYTES = kRows * HD * 2;
  constexpr int Q_BYTES = BQ * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = smem_1024(smem_raw);
  unsigned char* Vs = Ks + KV_BYTES;
  unsigned char* Ring = Vs + KV_BYTES;
  float* Stats = reinterpret_cast<float*>(Ring + ST * 2 * Q_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(Stats + ST * 2 * BQ);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int n_all = (p.S + BQ - 1) / BQ;
  const int qt0 = first_q_tile(p, k0, BQ, n_all);
  const int n_qt = n_all - qt0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1 + 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    producer_regs();
    const int pw = (threadIdx.x - kConsumers) >> 5, lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(kvbar, 2 * KV_BYTES);
      for (int a = 0; a < NA; ++a) {
        tma_load(Ks + a * kRows * 128, &tk, kvbar, 64 * a, k0, bh);
        tma_load(Vs + a * kRows * 128, &tv, kvbar, 64 * a, k0, bh);
      }
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(&empty[st], (j / ST - 1) & 1);
        mbar_expect_tx(&full[st], 2 * Q_BYTES);
        unsigned char* qd = Ring + st * 2 * Q_BYTES;
        const int r0 = (qt0 + j) * BQ;
        for (int a = 0; a < NA; ++a) {
          tma_load(qd + a * BQ * 128, &tq, &full[st], 64 * a, r0, bh);
          tma_load(qd + Q_BYTES + a * BQ * 128, &tdo, &full[st], 64 * a, r0,
                   bh);
        }
      }
    } else if (pw == 1) {
      const float* lse = p.lse + (size_t)bh * p.S;
      const float* delta = p.delta + (size_t)bh * p.S;
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(&empty[st], (j / ST - 1) & 1);
        float* l2 = Stats + st * 2 * BQ;
        const int r0 = (qt0 + j) * BQ;
        for (int i = lane; i < BQ; i += 32) {
          l2[i] = lse2_of(p, lse, r0 + i);
          l2[BQ + i] = delta_of(p, delta, r0 + i);
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    consumer_regs();
    dkv_consume<HD, BQ, ST>(p, Ks, Vs, Ring, Stats, full, empty, kvbar, k0,
                            qt0, n_qt);
  }
}

// ---------------------------------------------------------------------------
// bf16 dk / dv at hd 256: mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// A fragment (16 rows x 16 columns, row-major) at `a` in shared memory of
// row stride LD: thread (g, t) holds rows g and g + 8, columns 2t, 2t + 1,
// 2t + 8, 2t + 9.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* p) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// The A fragment of columns 16j .. 16j + 15 of a 16-row accumulator held
// as m16n8 tiles: tiles 2j and 2j + 1, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], float (&c)[N][4],
                                         int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// Copy rows [r0, r0 + rows) of a [n, HD] bf16 slab into shared rows of
// stride LD, 16 bytes a thread; rows at or past n are zero.
template <int HD, int LD, int NT>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int rows, int n) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// dk / dv.  Warp w owns keys 16 (w % 4) .. 16 (w % 4) + 15 of the block's
// 64 and output columns [HC (w / 4), HC (w / 4 + 1)), HC = HD / SPLIT:
// thread (g, t) holds keys g and g + 8 of its 16, q-row columns 2t, 2t + 1
// of every 8-wide score tile.
template <int HD, int BQ, int SPLIT>
__global__ void __launch_bounds__(128 * SPLIT)
flash_bwd_dkv_bf16_kernel(Params p) {
  constexpr int LD = HD + 8, NT = 128 * SPLIT, HC = HD / SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBK * LD;
  __nv_bfloat16* Qs = Vs + kBK * LD;
  __nv_bfloat16* Os = Qs + BQ * LD;  // dO
  float* L2s = reinterpret_cast<float*>(Os + BQ * LD);
  float* Ds = L2s + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp & 3) * 16 + g;  // tile keys kr and kr + 8
  const int c0 = (warp >> 2) * HC;     // first output column
  const size_t qoff = (size_t)bh * p.S * HD, koff = (size_t)bh * p.K * HD;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + qoff;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(p.dout) + qoff;
  const float* lse = p.lse + (size_t)bh * p.S;
  const float* delta = p.delta + (size_t)bh * p.S;

  stage_bf16<HD, LD, NT>(
      Ks, static_cast<const __nv_bfloat16*>(p.k) + koff, k0, kBK, p.K);
  stage_bf16<HD, LD, NT>(
      Vs, static_cast<const __nv_bfloat16*>(p.v) + koff, k0, kBK, p.K);

  const int keys[2] = {k0 + kr, k0 + kr + 8};
  float dk[HC / 8][4], dv[HC / 8][4];
#pragma unroll
  for (int n = 0; n < HC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (p.S + BQ - 1) / BQ;
  for (int qt = first_q_tile(p, k0, BQ, n_qt); qt < n_qt; ++qt) {
    const int r0 = qt * BQ;
    __syncthreads();  // the previous tile is consumed
    stage_bf16<HD, LD, NT>(Qs, q, r0, BQ, p.S);
    stage_bf16<HD, LD, NT>(Os, dout, r0, BQ, p.S);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      L2s[i] = lse2_of(p, lse, r0 + i);
      Ds[i] = delta_of(p, delta, r0 + i);
    }
    __syncthreads();

    // s^T = k . q^T and dp^T = v . dO^T: this warp's 16 keys x BQ rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, Ks + kr * LD + kk * 16 + 2 * t);
      frag_a<LD>(va, Vs + kr * LD + kk * 16 + 2 * t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], ka, ld32(Qs + off), ld32(Qs + off + 8));
        mma_bf16(dp[n], va, ld32(Os + off), ld32(Os + off + 8));
      }
    }

    // p^T on the valid pairs (kept in s), ds^T (kept in dp)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float pv = pair_ok(p, r0 + col, keys[e >> 1])
                             ? exp2f(s[n][e] * p.scale_log2 - L2s[col])
                             : 0.f;
        s[n][e] = pv;
        dp[n][e] = pv * (dp[n][e] - Ds[col]) * p.scale;
      }

    // dv += p^T . dO, dk += ds^T . q over the tile's q rows
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t pa[4], da[4];
      acc_to_a<BQ / 8>(pa, s, j);
      acc_to_a<BQ / 8>(da, dp, j);
      const int rowoff = (j * 16 + (lane & 15)) * LD + c0;
#pragma unroll
      for (int n = 0; n < HC / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Os + rowoff + n * 8);
        mma_bf16(dv[n], pa, b0, b1);
        ldmatrix_x2_trans(b0, b1, Qs + rowoff + n * 8);
        mma_bf16(dk[n], da, b0, b1);
      }
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + koff;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.K) continue;
#pragma unroll
    for (int n = 0; n < HC / 8; ++n) {
      const size_t o = (size_t)keys[r] * HD + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + o) =
          pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvp + o) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
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
  for (int i = threadIdx.x; i < rows * CH; i += 128) {
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

// dq.  Thread (rg = tid / 8, cg = tid % 8) owns tile rows 4 rg .. 4 rg + 3,
// keys cg + 8 j of each tile and dq columns cg + 8 j; the 8 threads sharing
// a row are neighbouring lanes of one warp, so the ds rows they write to
// shared memory are read back by that warp alone.
template <int HD, int BK>
__global__ void __launch_bounds__(128)
flash_bwd_dq_f32_kernel(Params p) {
  constexpr int LD = HD + 1, LDP = BK + 2;  // bank padding
  constexpr int NJ = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][LD]
  float* Os = Qs + kBQ * LD;                       // dO, [kBQ][LD]
  float* Ks = Os + kBQ * LD;                       // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* Ps = Vs + BK * LD;                        // ds, [kBQ][LDP]

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const size_t qoff = (size_t)bh * p.S * HD, koff = (size_t)bh * p.K * HD;
  const float* k = static_cast<const float*>(p.k) + koff;
  const float* v = static_cast<const float*>(p.v) + koff;
  const float* lse = p.lse + (size_t)bh * p.S;
  const float* delta = p.delta + (size_t)bh * p.S;

  stage_f32<HD, LD>(Qs, static_cast<const float*>(p.q) + qoff, q0, kBQ, p.S);
  stage_f32<HD, LD>(Os, static_cast<const float*>(p.dout) + qoff, q0, kBQ,
                    p.S);

  float l2[4], dl[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l2[i] = lse2_of(p, lse, q0 + rg * 4 + i);
    dl[i] = delta_of(p, delta, q0 + rg * 4 + i);
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = key_tiles(p, q0, kBQ, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage_f32<HD, LD>(Ks, k, k0, BK, p.K);
    stage_f32<HD, LD>(Vs, v, k0, BK, p.K);
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg * 4 + i) * LD + d];
        ov[i] = Os[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[(cg + 8 * j) * LD + d];
        const float vv = Vs[(cg + 8 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(ov[i], vv, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pv =
            pair_ok(p, q0 + rg * 4 + i, k0 + cg + 8 * j)
                ? exp2f(s[i][j] * p.scale_log2 - l2[i])
                : 0.f;
        Ps[(rg * 4 + i) * LDP + cg + 8 * j] =
            pv * (dp[i][j] - dl[i]) * p.scale;
      }
    __syncwarp();  // a row's ds come from lanes of this warp

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ps[(rg * 4 + i) * LDP + key];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float kv = Ks[key * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

  float* dq = static_cast<float*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) dq[(size_t)row * HD + cg + 8 * j] = acc[i][j];
  }
}

// dk / dv.  Thread (rg = tid / 8, cg = tid % 8) owns tile keys RK rg ..
// RK rg + RK - 1 (RK = BK / 16), q rows cg + 8 j of each streamed tile and
// output columns cg + 8 j; p^T and ds^T rows go through shared memory read
// back by the owning warp alone.
template <int HD, int BK, int BQ>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int LD = HD + 1, LDP = BQ + 2;  // bank padding
  constexpr int RK = BK / 16, NJ = BQ / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][LD]
  float* Qs = Vs + BK * LD;                        // [BQ][LD]
  float* Os = Qs + BQ * LD;                        // dO, [BQ][LD]
  float* Ps = Os + BQ * LD;                        // p^T, [BK][LDP]
  float* DSs = Ps + BK * LDP;                      // ds^T, [BK][LDP]
  float* L2s = DSs + BK * LDP;                     // [BQ]
  float* Ds = L2s + BQ;                            // [BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const size_t qoff = (size_t)bh * p.S * HD, koff = (size_t)bh * p.K * HD;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* dout = static_cast<const float*>(p.dout) + qoff;
  const float* lse = p.lse + (size_t)bh * p.S;
  const float* delta = p.delta + (size_t)bh * p.S;

  stage_f32<HD, LD>(Ks, static_cast<const float*>(p.k) + koff, k0, BK, p.K);
  stage_f32<HD, LD>(Vs, static_cast<const float*>(p.v) + koff, k0, BK, p.K);

  float dk[RK][ND], dv[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_qt = (p.S + BQ - 1) / BQ;
  for (int qt = first_q_tile(p, k0, BQ, n_qt); qt < n_qt; ++qt) {
    const int r0 = qt * BQ;
    __syncthreads();
    stage_f32<HD, LD>(Qs, q, r0, BQ, p.S);
    stage_f32<HD, LD>(Os, dout, r0, BQ, p.S);
    for (int i = threadIdx.x; i < BQ; i += 128) {
      L2s[i] = lse2_of(p, lse, r0 + i);
      Ds[i] = delta_of(p, delta, r0 + i);
    }
    __syncthreads();

    float s[RK][NJ], dp[RK][NJ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = Ks[(rg * RK + i) * LD + d];
        vv[i] = Vs[(rg * RK + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float qv = Qs[(cg + 8 * j) * LD + d];
        const float ov = Os[(cg + 8 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          s[i][j] = fmaf(kv[i], qv, s[i][j]);
          dp[i][j] = fmaf(vv[i], ov, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = cg + 8 * j;
        const float pv = pair_ok(p, r0 + col, k0 + rg * RK + i)
                             ? exp2f(s[i][j] * p.scale_log2 - L2s[col])
                             : 0.f;
        Ps[(rg * RK + i) * LDP + col] = pv;
        DSs[(rg * RK + i) * LDP + col] = pv * (dp[i][j] - Ds[col]) * p.scale;
      }
    __syncwarp();  // a key's p^T / ds^T rows come from lanes of this warp

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[RK], dsv[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = Ps[(rg * RK + i) * LDP + c];
        dsv[i] = DSs[(rg * RK + i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float ov = Os[c * LD + cg + 8 * j];
        const float qv = Qs[c * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
        }
      }
    }
    __syncwarp();  // Ps / DSs are rewritten by the next tile
  }

  float* dkp = static_cast<float*>(p.dk) + koff;
  float* dvp = static_cast<float*>(p.dv) + koff;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + rg * RK + i;
    if (key >= p.K) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkp[(size_t)key * HD + cg + 8 * j] = dk[i][j];
      dvp[(size_t)key * HD + cg + 8 * j] = dv[i][j];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The four tensor maps of a wgmma kernel: q and dO in boxes of q_box rows,
// k and v in boxes of k_box.  An empty side (K = 0 for dq, S = 0 for dk /
// dv) is never read, but its maps must describe real memory: the other
// side's.
cudaError_t bwd_maps(CUtensorMap (&m)[4], const Params& p, int BH, int HD,
                     int q_box, int k_box) {
  const bool rows = p.S > 0, keys = p.K > 0;
  const void* qs[2] = {rows ? p.q : p.k, rows ? p.dout : p.v};
  const void* ks[2] = {keys ? p.k : p.q, keys ? p.v : p.dout};
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = tensor_map(&m[i], qs[i], BH, rows ? p.S : p.K, HD, q_box);
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = tensor_map(&m[2 + i], ks[i], BH, keys ? p.K : p.S, HD, k_box);
  return e;
}

template <typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, dim3 grid, size_t smem,
                         const CUtensorMap (&m)[4], const Params& p,
                         cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreadsWg, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

template <int HD, int BK, int ST, bool PIPE>
cudaError_t dq_wgmma(const Params& p, int BH, cudaStream_t s) {
  CUtensorMap m[4];
  const cudaError_t e = bwd_maps(m, p, BH, HD, kRows, BK);
  if (e != cudaSuccess) return e;
  const size_t smem = 1024 + (size_t)2 * kRows * HD * 2 +
                      (size_t)ST * 2 * BK * HD * 2 + (2 * ST + 1) * 8;
  return launch_wgmma(flash_bwd_dq_wgmma_kernel<HD, BK, ST, PIPE>,
                      dim3((p.S + kRows - 1) / kRows, BH), smem, m, p, s);
}

template <int HD, int BK>
cudaError_t dq_f32(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = ((size_t)(2 * kBQ + 2 * BK) * (HD + 1) +
                       (size_t)kBQ * (BK + 2)) * 4;
  return launch(flash_bwd_dq_f32_kernel<HD, BK>,
                dim3((p.S + kBQ - 1) / kBQ, BH), 128, smem, p, s);
}

template <int HD, int BQ, int SPLIT>
cudaError_t dkv_bf16(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = (size_t)(2 * kBK + 2 * BQ) * (HD + 8) * 2 +
                      (size_t)2 * BQ * 4;
  return launch(flash_bwd_dkv_bf16_kernel<HD, BQ, SPLIT>,
                dim3((p.K + kBK - 1) / kBK, BH), 128 * SPLIT, smem, p, s);
}

template <int HD, int BQ, int ST>
cudaError_t dkv_wgmma(const Params& p, int BH, cudaStream_t s) {
  CUtensorMap m[4];
  const cudaError_t e = bwd_maps(m, p, BH, HD, BQ, kRows);
  if (e != cudaSuccess) return e;
  const size_t smem = 1024 + (size_t)2 * kRows * HD * 2 +
                      (size_t)ST * 2 * BQ * HD * 2 + (size_t)ST * 2 * BQ * 4 +
                      (2 * ST + 1) * 8;
  return launch_wgmma(flash_bwd_dkv_wgmma_kernel<HD, BQ, ST>,
                      dim3((p.K + kRows - 1) / kRows, BH), smem, m, p, s);
}

template <int HD, int BK, int BQ>
cudaError_t dkv_f32(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = ((size_t)(2 * BK + 2 * BQ) * (HD + 1) +
                       (size_t)2 * BK * (BQ + 2) + 2 * BQ) * 4;
  return launch(flash_bwd_dkv_f32_kernel<HD, BK, BQ>,
                dim3((p.K + BK - 1) / BK, BH), 128, smem, p, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int S, int K,
                   long long q_off, int causal, float sm_scale) {
  return Params{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), dq, dk, dv, S, K, q_off,
                causal ? 1 : 0, sm_scale, sm_scale * kLog2e};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it).  Layouts (all contiguous, 16-byte aligned): q, dout, dq [BH, S, hd];
// k, v, dk, dv [BH, K, hd]; lse, delta [BH, S] float32 (lse as the forward
// returned it, -inf for a row with no valid key).  hd in {64, 128, 256};
// q_off any value.  Each launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t.

// dq: S >= 1, K >= 0 (K = 0 gives dq = 0).
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int BH, int S, int K, int hd,
                                      long long q_off, int causal,
                                      float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || K < 0) return cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, S, K, q_off, causal, sm_scale);
  if (dtype == 1) {
    if (hd == 64) return dq_wgmma<64, 128, 3, false>(p, BH, st);
    if (hd == 128) return dq_wgmma<128, 64, 3, true>(p, BH, st);
    if (hd == 256) return dq_wgmma<256, 32, 3, false>(p, BH, st);
  } else if (dtype == 0) {
    if (hd == 64) return dq_f32<64, 64>(p, BH, st);
    if (hd == 128) return dq_f32<128, 64>(p, BH, st);
    if (hd == 256) return dq_f32<256, 32>(p, BH, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dk / dv: K >= 1, S >= 0 (S = 0 gives dk = dv = 0).
extern "C" int flash_attention_bwd_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int BH, int S, int K, int hd,
                                       long long q_off, int causal,
                                       float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S < 0 || K <= 0) return cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, S,
                               K, q_off, causal, sm_scale);
  if (dtype == 1) {
    if (hd == 64) return dkv_wgmma<64, 128, 2>(p, BH, st);
    if (hd == 128) return dkv_wgmma<128, 64, 3>(p, BH, st);
    if (hd == 256) return dkv_bf16<256, 32, 2>(p, BH, st);
  } else if (dtype == 0) {
    if (hd == 64) return dkv_f32<64, 64, 64>(p, BH, st);
    if (hd == 128) return dkv_f32<128, 32, 64>(p, BH, st);
    if (hd == 256) return dkv_f32<256, 32, 32>(p, BH, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
