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
// masked here (zero-filled shared rows, the masks above); the host never
// pads.
//
// What bounds them on an H100: operations.  Per valid (q, key) pair the dq
// kernel does 6 * hd flops (q.k^T, dO.v^T, ds.k) and the dk / dv kernel
// 8 * hd (q.k^T, dO.v^T, p^T.dO, ds^T.q); at S = K = 8192, hd 64, causal
// that is ~4000 flops a byte of q, k, v, dO, dq / dk / dv, far above the
// card's ~295 flop/byte ridge in bf16.  The score matrix never exists in
// device memory.
//
// What this first design does about it (simple and right before fast):
// * dq: one 128-thread block per (batch x head, 64-row q tile); q and dO
//   are staged in shared memory once, lse and delta held in registers; k
//   and v stream through shared memory one BK-key tile at a time, up to
//   the causal bound (kernel 4's); the blocks of the longest rows start
//   first.  bf16: all three products on the tensor cores (mma.sync
//   m16n8k16, bf16 in, float32 accumulators), each warp owning 16 q rows;
//   ds never leaves registers — the m16n8 accumulator layout of two score
//   tiles is the A-operand layout of the ds . k product — and k, [key][d]
//   in shared memory, feeds that product through ldmatrix.trans as v does
//   kernel 4's P . v.
// * dk / dv: one block per (batch x head, 64-key tile); k and v are staged
//   once; q, dO, lse and delta stream through shared memory one BQ-row
//   tile at a time, from the first tile that holds a row that sees a key
//   of the block (causal: row >= key - q_off).  bf16: the block computes
//   s^T = k . q^T and dp^T = v . dO^T directly, so a warp's accumulator
//   rows are its 16 keys and p^T and ds^T are A operands straight from
//   registers (nothing staged through shared memory); q and dO feed the
//   two products through ldmatrix.trans.  The float32 dk and dv
//   accumulators take 2 * hd floats a key: at hd 256 one warp's 16 keys
//   would need 256 registers a thread, so there two warps share each 16
//   keys, each accumulating half of the columns (256 threads; the two
//   recompute the same s^T and dp^T).  Causal, the first kv tiles carry
//   the most q tiles, and they are launched first.
// * float32 inputs take a SIMT path on the CUDA cores (TF32 is off by the
//   port's rule): per-thread register tiles, ds (and p) staged in shared
//   memory rows that only the owning warp reads.
// Where bf16 rounds: the TPU multiplies in float32; here p and ds are
// rounded to bf16 where they enter mma, and the outputs to bf16 once.
// Shared rows are padded so fragment loads hit distinct banks.  Not done
// yet (later work): cp.async / TMA double-buffering, wgmma, a persistent
// schedule.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (paddle_tpu_torch/ops/_build.py); plain C
// entries, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // q rows of a dq block
constexpr int kBK = 64;  // keys of a dk / dv block (bf16)

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

// dq.  Each warp owns 16 q rows: thread (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of them, columns 2t, 2t + 1 of every 8-wide accumulator
// tile (the m16n8 fragment layout).
template <int HD, int BK>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int LD = HD + 8;  // +16 bytes: fragment loads hit distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + kBQ * LD;  // dO
  __nv_bfloat16* Ks = Os + kBQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int bh = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * p.S * HD, koff = (size_t)bh * p.K * HD;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + koff;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + koff;
  const float* lse = p.lse + (size_t)bh * p.S;
  const float* delta = p.delta + (size_t)bh * p.S;

  stage_bf16<HD, LD, 128>(
      Qs, static_cast<const __nv_bfloat16*>(p.q) + qoff, q0, kBQ, p.S);
  stage_bf16<HD, LD, 128>(
      Os, static_cast<const __nv_bfloat16*>(p.dout) + qoff, q0, kBQ, p.S);

  const int row0 = warp * 16 + g;  // tile rows row0 and row0 + 8
  const int rows[2] = {q0 + row0, q0 + row0 + 8};
  const float l2[2] = {lse2_of(p, lse, rows[0]), lse2_of(p, lse, rows[1])};
  const float dl[2] = {delta_of(p, delta, rows[0]),
                       delta_of(p, delta, rows[1])};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = key_tiles(p, q0, kBQ, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    stage_bf16<HD, LD, 128>(Ks, k, k0, BK, p.K);
    stage_bf16<HD, LD, 128>(Vs, v, k0, BK, p.K);
    __syncthreads();

    // s = q . k^T and dp = dO . v^T for this warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a<LD>(qa, Qs + row0 * LD + kk * 16 + 2 * t);
      frag_a<LD>(oa, Os + row0 * LD + kk * 16 + 2 * t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int off = (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, ld32(Ks + off), ld32(Ks + off + 8));
        mma_bf16(dp[n], oa, ld32(Vs + off), ld32(Vs + off + 8));
      }
    }

    // p = exp(s - lse) on the valid pairs, ds = p (dp - delta) sm_scale
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + n * 8 + 2 * t + (e & 1);
        const float pv = pair_ok(p, rows[r], key)
                             ? exp2f(s[n][e] * p.scale_log2 - l2[r])
                             : 0.f;
        s[n][e] = pv * (dp[n][e] - dl[r]) * p.scale;
      }

    // dq += ds . k: two adjacent ds tiles are one A fragment
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      acc_to_a<BK / 8>(a, s, j);
      const __nv_bfloat16* krow = Ks + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, krow + n * 8);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.S) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + (size_t)rows[r] * HD + n * 8 +
                                   2 * t) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
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

template <int HD, int BK>
cudaError_t dq_bf16(const Params& p, int BH, cudaStream_t s) {
  const size_t smem = (size_t)(2 * kBQ + 2 * BK) * (HD + 8) * 2;
  return launch(flash_bwd_dq_bf16_kernel<HD, BK>,
                dim3((p.S + kBQ - 1) / kBQ, BH), 128, smem, p, s);
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
    if (hd == 64) return dq_bf16<64, 64>(p, BH, st);
    if (hd == 128) return dq_bf16<128, 64>(p, BH, st);
    if (hd == 256) return dq_bf16<256, 32>(p, BH, st);
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
    if (hd == 64) return dkv_bf16<64, 64, 1>(p, BH, st);
    if (hd == 128) return dkv_bf16<128, 32, 1>(p, BH, st);
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
