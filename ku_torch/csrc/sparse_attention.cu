// Block-sparse flash attention: the forward (with the f32 log-sum-exp), dq,
// and dk / dv, each walking the live entries of a host-built flat block map.
//
// Replaces ku/pallas/sparse_attention.py::_sparse_fwd_kernel,
// ::_sparse_dq_kernel and ::_sparse_dkv_kernel (through _sparse_fwd and
// _sparse_bwd, :230-569).
//
// Contract (ku's layout):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv), dout (B, H, N, Dv):
//     f32 with any strides, or bf16 whose rows can be copied 16 bytes at a
//     time (runs_aligned; the wrapper copies any other); D, Dv <= 128;
//     query head j reads KV head j / (H / Hkv).
//   map (E, 5) int32, ku's flat map [q_block, k_block, flag, first, last]:
//     fmap (grouped by query block) for the forward and dq, tmap (grouped by
//     key block) for dk / dv; ptr (nqb + 1) or (nkb + 1) int32: where each
//     block's run starts, so a block reads its own entries and no other.
//   lse, delta (B, H, N) f32 contiguous: the forward's log-sum-exp, and
//     delta = rowsum(dout * o) over the forward's stored (rounded) o.
//   o (B, H, N, Dv) in q's dtype, lse (B, H, N) f32; dq (B, H, N, D),
//     dk (B, Hkv, KN, D), dv (B, Hkv, KN, Dv) in the dtypes of q, k, v; all
//     contiguous.
// Per (query, key) pair of an entry, ku's _mask_sparse: a _FULL entry (flag
// 0) keeps every pair; otherwise keep k <= q when causal and, with a window,
// also q - k < window or k < global_prefix, from which a _CAUSAL_ONLY entry
// (flag 2) is exempt. Positions are global. s = (q . k) * scale, -1e30
// where masked (not -inf: exp(m_prev - m_new) must not turn into NaN).
// Forward: p = exp(s - m) in f32, rounded to v's dtype before the PV
// product, whose sum is f32; o = acc / max(l, 1e-30), lse = m + log(l). A
// row with no live key writes o = 0 and lse = -1e30 (ku: the mean of the
// masked values). Backward: p = exp(s - lse) for a live pair and 0 for a
// masked one, set explicitly (lse = -1e30 on a dead row); dp = dout . v;
// ds = p * (dp - delta); dq = scale * sum_k ds . k with ds rounded to k's
// dtype; dv = sum_q p . dout with p rounded to dout's dtype; dk = scale *
// sum_q ds . q with ds rounded to q's dtype. Every sum is f32.
//
// What bounds it on an H100: at the LM's training shape (B = 1, H = 16 over
// Hkv = 4, N = KN = 8,192, D = 128, bf16, 512 x 512 blocks, a window of
// 2,048 keys plus 128 sinks) the mask keeps 15.5 M pairs a head, 247 M a
// call. The forward does 4 * D operations a pair (s and PV), 127 GFLOP,
// 0.13 ms at the 989 TFLOP/s bf16 tensor-core peak; dq 6 * D, 0.19 ms;
// dk / dv 8 * D, 0.26 ms. Each moves about 0.1 GB (q, k, v, dout, lse,
// delta once, its outputs once), 0.03 ms at 3.35 TB/s: operations bound all
// three.
//
// Two routes, chosen by dtype at the C entry; nothing falls back from one
// to the other.
// - bf16: the tensor-core kernels (sparse_{fwd,dq,dkv}_wgmma_kernel, over
//   attn_mma.cuh). Every product is a warpgroup wgmma (bf16 in, f32 sums):
//   S = Q K^T and dP = dO V^T (and their transposes in dk / dv) with both
//   operands read from shared memory, O += P V, dQ += dS K, dV += P^T dO
//   and dK += dS^T Q with A in registers and B read transposed. Tiles sit
//   in wgmma's 128-byte swizzled layout, filled by 16-byte cp.async copies
//   that zero-fill rows past the tile's end and columns past the head's
//   width, so that any D, Dv <= 128 and any block size work and a NaN
//   outside the tile is never read; the walked tiles (K and V, or Q, dO,
//   lse and delta) are double-buffered, the next one copied during this
//   one's products. Scores stay in the accumulator fragments: the online
//   softmax (forward), or p and ds (backward), work on them with quad
//   shuffles, and p or ds, rounded to bf16 in registers, is the A operand
//   of the next product (FlashAttention-2's scheme). A sub-tile whose
//   corners pass every clause of the mask tests no pair; otherwise a
//   bitmask of kept pairs is built once and a masked pair's exp takes -inf
//   (no branch around it). Forward and dq: one warpgroup, two blocks an
//   SM; dk / dv: two warpgroups, one block an SM. Each group of products
//   is waited for before its results are used (no overlap of products with
//   the softmax inside a block; two blocks an SM overlap each other). What
//   bounds them is not measured apart (no ncu on that machine); their times
//   in PERF.md are 4-5x the bounds.
// - f32: the CUDA-core kernels (sparse_{fwd,dq,dkv}_kernel): 256-thread
//   blocks over 64 x 64 f32 tiles in shared memory, rows padded to D + 1 and
//   65 words so that the 8 rows a warp reads lie on distinct banks; thread t
//   owns row t / 4 and columns t % 4 + 4 j of a tile, as in the flash
//   kernels. Their f32 FMA and shared-memory rate bound them, at 100-125x
//   the bounds (bf16 took this route too, before the tensor-core kernels);
//   TF32 would not meet the f32 comparisons, so f32 stays here.
//
// Design common to both, with the TPU's sequential map axis a loop inside
// the block over its run of the map. A TPU block of 512 rows is 256 KB in
// f32 at D = 128, past an SM's 227 KB, so a CUDA block takes a 64-row
// sub-tile of one map block and never straddles two (any block size works:
// a block of 16 rows is one sub-tile with 48 idle rows; 512 is eight).
// - forward and dq: one block per (batch * head, 64-query sub-tile). It
//   walks its query block's run of fmap and, inside each entry, the key
//   block's 64-key sub-tiles with one online softmax (forward) or one dq
//   accumulator (dq) in f32 registers; writes once, after the run.
// - dk / dv: one block per (batch * KV head, 64-key sub-tile). It walks its
//   key block's run of tmap for every query head of the group, summing the
//   group in registers (no atomics, one rounding). An empty run (a key block
//   no query attends) writes zeros without reading K or V: ku's zero_fill
//   pass, with no extra pass. The work of a key tile is the length of its
//   run: under the LM's mask a sink tile is walked by all 16 query blocks,
//   4.2 times the average, so the grid starts those tiles first (the KV
//   head on its fast axis); started last, in the grid's last wave, they
//   made dk / dv take 2.4 times dq (PERF.md).
// A partial entry skips its 64 x 64 sub-tiles that hold no live pair (the
// causal edge's upper triangle, the window's far corner, a sink block's
// keys past the prefix), by a block-uniform test on the sub-tile's corners.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kT = 64, kThreads = 256;  // sub-tile rows, of queries and keys
constexpr int kCols = kT / 4;           // pairs of a tile row one thread computes
constexpr int kMaxD = 128;              // widest head instantiated (D and Dv)
constexpr float kMasked = -1e30f;
// ku's map columns and flags.
constexpr int kQI = 0, kKB = 1, kFlag = 2, kWidth = 5;
constexpr int kFull = 0, kCausalOnly = 2;

// The CUDA-core kernels below are instantiated for f32 only (bf16 takes the
// tensor-core kernels further down); these keep their element type T.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Strides {
  long long b, h, n, d;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;     // o, lse; or dq; or dk, dv
  const int *map, *ptr;  // the flat map and where each block's run starts
  int h, hkv, n, kn, d, dv, block_q, block_k;
  Strides sq, sk, sv, so;
  float scale;
  int causal, has_window, window, global_prefix;
};

// As flash_fwd.cu: stage rows [row0, row0 + rows) x [0, cols) of a strided
// (n, cols) slab into dst (leading dimension ld) as f32, zero from row `end`
// on, the loop along the unit-stride axis so that neighbouring threads read
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long sn, long long sd, int row0,
                                      int rows, int end, int cols) {
  const int total = rows * cols;
  if (sd == 1 || sn != 1) {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / cols, c = e % cols;
      const int row = row0 + r;
      dst[r * ld + c] = row < end ? to_f32(src[row * sn + c * sd]) : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int c = e / rows, r = e % rows;
      const int row = row0 + r;
      dst[r * ld + c] = row < end ? to_f32(src[row * sn + c * sd]) : 0.f;
    }
  }
}

// ku's _mask_sparse for one pair of an entry with `flag`.
__device__ __forceinline__ bool keep_pair(const Args& a, int flag, int qi, int ki) {
  if (flag == kFull) return true;
  bool keep = !a.causal || ki <= qi;
  if (a.has_window)
    keep = keep && (flag == kCausalOnly || qi - ki < a.window || ki < a.global_prefix);
  return keep;
}

// Whether the sub-tile of queries [q0, q1] x keys [k0, k1] may hold a live
// pair: false only when one clause of the mask fails for every pair.
__device__ __forceinline__ bool tile_live(const Args& a, int flag, int q0, int q1,
                                          int k0, int k1) {
  if (flag == kFull) return true;
  if (a.causal && k0 > q1) return false;
  if (a.has_window && flag != kCausalOnly && q0 - k1 >= a.window &&
      k0 >= a.global_prefix)
    return false;
  return true;
}

// Whether every pair of the sub-tile is live (the corners pass every clause
// of the mask): then the per-pair test is skipped.
__device__ __forceinline__ bool tile_full(const Args& a, int flag, int q0, int q1, int k0,
                                          int k1) {
  if (flag == kFull) return true;
  if (a.causal && k1 > q0) return false;
  if (a.has_window && flag != kCausalOnly && q1 - k0 >= a.window &&
      k1 >= a.global_prefix)
    return false;
  return true;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) sparse_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv;
  const int ldq = d + 1, ldv = dv + 1, ldp = kT + 1;
  float* qs = smem;            // kT x ldq
  float* ks = qs + kT * ldq;   // kT x ldq
  float* vs = ks + kT * ldq;   // kT x ldv
  float* ps = vs + kT * ldv;   // kT x ldp

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  const int bh = blockIdx.y, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int tiles = (a.block_q + kT - 1) / kT;
  const int qb = blockIdx.x / tiles;
  const int q_start = qb * a.block_q + (blockIdx.x % tiles) * kT;
  const int q_end = min(q_start + kT, (qb + 1) * a.block_q);
  const int qi = q_start + r;
  const bool row_valid = qi < q_end;

  const T* kb_ptr = k + b * a.sk.b + hk * a.sk.h;
  const T* vb_ptr = v + b * a.sv.b + hk * a.sv.h;
  stage(qs, ldq, q + b * a.sq.b + hq * a.sq.h, a.sq.n, a.sq.d, q_start, kT, q_end, d);

  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;
  float m_run = kMasked, l_run = 0.f;

  for (int e = a.ptr[qb]; e < a.ptr[qb + 1]; ++e) {
    const int* ent = a.map + (long long)e * kWidth;
    const int kb = ent[kKB], flag = ent[kFlag];
    const int kb_end = (kb + 1) * a.block_k;
    for (int k_start = kb * a.block_k; k_start < kb_end; k_start += kT) {
      const int k_end = min(k_start + kT, kb_end);
      if (!tile_live(a, flag, q_start, q_end - 1, k_start, k_end - 1)) continue;
      __syncthreads();  // the previous tile is done with ks, vs, ps
      stage(ks, ldq, kb_ptr, a.sk.n, a.sk.d, k_start, kT, k_end, d);
      stage(vs, ldv, vb_ptr, a.sv.n, a.sv.d, k_start, kT, k_end, dv);
      __syncthreads();

      float s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = 0.f;
      const float* qrow = qs + r * ldq;
      for (int dd = 0; dd < d; ++dd) {
        const float x = qrow[dd];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[j] += x * ks[(c0 + 4 * j) * ldq + dd];
      }
      float mt = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k_start + c0 + 4 * j;
        const bool keep = key < k_end && keep_pair(a, flag, qi, key);
        s[j] = keep ? s[j] * a.scale : kMasked;
        mt = fmaxf(mt, s[j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      const float corr = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        ps[r * ldp + c0 + 4 * j] = round_as(p, v);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * corr + sum;
      m_run = m_new;
      __syncwarp();  // row r of ps is written and read by the same 4 threads

#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) acc[j] *= corr;
      const float* prow = ps + r * ldp;
      for (int c = 0; c < kT; ++c) {
        const float p = prow[c];
        const float* vrow = vs + c * ldv;
#pragma unroll
        for (int j = 0; j < DMAX / 4; ++j) {
          const int col = c0 + 4 * j;
          if (col < dv) acc[j] += p * vrow[col];
        }
      }
    }
  }

  if (row_valid) {
    // m_run is still the masked value only when no key of the row was live
    // (masked keys of a visited tile then sum into l and acc): write 0.
    const bool none = m_run == kMasked;
    const float l = fmaxf(l_run, 1e-30f);
    const long long row = (long long)bh * a.n + qi;
    T* orow = static_cast<T*>(a.out0) + row * dv;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c0 + 4 * j;
      if (col < dv) store(orow + col, none ? 0.f : acc[j] / l);
    }
    if (c0 == 0) static_cast<float*>(a.out1)[row] = none ? kMasked : m_run + logf(l);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) sparse_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv;
  const int ldq = d + 1, ldv = dv + 1, ldp = kT + 1;
  float* qs = smem;             // kT x ldq
  float* dos = qs + kT * ldq;   // kT x ldv
  float* ks = dos + kT * ldv;   // kT x ldq
  float* vs = ks + kT * ldq;    // kT x ldv
  float* dss = vs + kT * ldv;   // kT x ldp

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  const int bh = blockIdx.y, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int tiles = (a.block_q + kT - 1) / kT;
  const int qb = blockIdx.x / tiles;
  const int q_start = qb * a.block_q + (blockIdx.x % tiles) * kT;
  const int q_end = min(q_start + kT, (qb + 1) * a.block_q);
  const int qi = q_start + r;
  const bool row_valid = qi < q_end;
  const long long row = (long long)bh * a.n + qi;
  const float row_lse = row_valid ? a.lse[row] : 0.f;
  const float row_delta = row_valid ? a.delta[row] : 0.f;

  const T* kb_ptr = k + b * a.sk.b + hk * a.sk.h;
  const T* vb_ptr = v + b * a.sv.b + hk * a.sv.h;
  stage(qs, ldq, q + b * a.sq.b + hq * a.sq.h, a.sq.n, a.sq.d, q_start, kT, q_end, d);
  stage(dos, ldv, dout + b * a.so.b + hq * a.so.h, a.so.n, a.so.d, q_start, kT, q_end, dv);

  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  for (int e = a.ptr[qb]; e < a.ptr[qb + 1]; ++e) {
    const int* ent = a.map + (long long)e * kWidth;
    const int kb = ent[kKB], flag = ent[kFlag];
    const int kb_end = (kb + 1) * a.block_k;
    for (int k_start = kb * a.block_k; k_start < kb_end; k_start += kT) {
      const int k_end = min(k_start + kT, kb_end);
      if (!tile_live(a, flag, q_start, q_end - 1, k_start, k_end - 1)) continue;
      __syncthreads();  // the previous tile is done with ks, vs, dss
      stage(ks, ldq, kb_ptr, a.sk.n, a.sk.d, k_start, kT, k_end, d);
      stage(vs, ldv, vb_ptr, a.sv.n, a.sv.d, k_start, kT, k_end, dv);
      __syncthreads();

      float s[kCols], dp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
      const float* qrow = qs + r * ldq;
      for (int dd = 0; dd < d; ++dd) {
        const float x = qrow[dd];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[j] += x * ks[(c0 + 4 * j) * ldq + dd];
      }
      const float* orow = dos + r * ldv;
      for (int dd = 0; dd < dv; ++dd) {
        const float x = orow[dd];
#pragma unroll
        for (int j = 0; j < kCols; ++j) dp[j] += x * vs[(c0 + 4 * j) * ldv + dd];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + 4 * j, key = k_start + c;
        const bool keep = row_valid && key < k_end && keep_pair(a, flag, qi, key);
        const float p = keep ? expf(s[j] * a.scale - row_lse) : 0.f;
        dss[r * ldp + c] = round_as(p * (dp[j] - row_delta), k);
      }
      __syncwarp();  // row r of dss is written and read by the same 4 threads

      const float* drow = dss + r * ldp;
      for (int c = 0; c < kT; ++c) {
        const float w = drow[c];
        const float* krow = ks + c * ldq;
#pragma unroll
        for (int j = 0; j < DMAX / 4; ++j) {
          const int col = c0 + 4 * j;
          if (col < d) acc[j] += w * krow[col];
        }
      }
    }
  }

  if (row_valid) {
    T* out = static_cast<T*>(a.out0) + row * d;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c0 + 4 * j;
      if (col < d) store(out + col, a.scale * acc[j]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) sparse_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv;
  const int ldq = d + 1, ldv = dv + 1, ldp = kT + 1;
  float* ks = smem;              // kT x ldq
  float* vs = ks + kT * ldq;     // kT x ldv
  float* qs = vs + kT * ldv;     // kT x ldq
  float* dos = qs + kT * ldq;    // kT x ldv
  float* ps = dos + kT * ldv;    // kT x ldp
  float* dss = ps + kT * ldp;    // kT x ldp
  float* lse_s = dss + kT * ldp; // kT
  float* delta_s = lse_s + kT;   // kT

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  // The KV head is the grid's fast axis (see the launch).
  const int bkv = blockIdx.x, b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.h / a.hkv;
  const int tiles = (a.block_k + kT - 1) / kT;
  const int kb = blockIdx.y / tiles;
  const int k_start = kb * a.block_k + (blockIdx.y % tiles) * kT;
  const int k_end = min(k_start + kT, (kb + 1) * a.block_k);
  const int ki = k_start + r;
  const bool key_valid = ki < k_end;
  const int e0 = a.ptr[kb], e1 = a.ptr[kb + 1];

  float dk_acc[DMAX / 4], dv_acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  if (e0 < e1) {  // an unattended key block reads nothing and writes zeros
    stage(ks, ldq, k + b * a.sk.b + hk * a.sk.h, a.sk.n, a.sk.d, k_start, kT, k_end, d);
    stage(vs, ldv, v + b * a.sv.b + hk * a.sv.h, a.sv.n, a.sv.d, k_start, kT, k_end, dv);
  }
  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const long long bh = (long long)b * a.h + hq;
    const T* qb_ptr = q + b * a.sq.b + hq * a.sq.h;
    const T* ob_ptr = dout + b * a.so.b + hq * a.so.h;
    for (int e = e0; e < e1; ++e) {
      const int* ent = a.map + (long long)e * kWidth;
      const int qblk = ent[kQI], flag = ent[kFlag];
      const int qb_end = (qblk + 1) * a.block_q;
      for (int q_start = qblk * a.block_q; q_start < qb_end; q_start += kT) {
        const int q_end = min(q_start + kT, qb_end);
        if (!tile_live(a, flag, q_start, q_end - 1, k_start, k_end - 1)) continue;
        __syncthreads();  // the previous tile is done with qs, dos, ps, dss
        stage(qs, ldq, qb_ptr, a.sq.n, a.sq.d, q_start, kT, q_end, d);
        stage(dos, ldv, ob_ptr, a.so.n, a.so.d, q_start, kT, q_end, dv);
        if (tid < kT) {
          const int row = q_start + tid;
          const bool ok = row < q_end;
          lse_s[tid] = ok ? a.lse[bh * a.n + row] : 0.f;
          delta_s[tid] = ok ? a.delta[bh * a.n + row] : 0.f;
        }
        __syncthreads();

        float s[kCols], dp[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
        const float* krow = ks + r * ldq;
        for (int dd = 0; dd < d; ++dd) {
          const float x = krow[dd];
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[j] += x * qs[(c0 + 4 * j) * ldq + dd];
        }
        const float* vrow = vs + r * ldv;
        for (int dd = 0; dd < dv; ++dd) {
          const float x = vrow[dd];
#pragma unroll
          for (int j = 0; j < kCols; ++j) dp[j] += x * dos[(c0 + 4 * j) * ldv + dd];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + 4 * j, qi = q_start + c;
          const bool keep = key_valid && qi < q_end && keep_pair(a, flag, qi, ki);
          const float p = keep ? expf(s[j] * a.scale - lse_s[c]) : 0.f;
          ps[r * ldp + c] = round_as(p, dout);
          dss[r * ldp + c] = round_as(p * (dp[j] - delta_s[c]), q);
        }
        __syncwarp();  // rows r of ps and dss: written and read by 4 threads

        const float* prow = ps + r * ldp;
        const float* drow = dss + r * ldp;
        for (int c = 0; c < kT; ++c) {
          const float pw = prow[c], dw = drow[c];
          const float* orow = dos + c * ldv;
          const float* qrow = qs + c * ldq;
#pragma unroll
          for (int j = 0; j < DMAX / 4; ++j) {
            const int col = c0 + 4 * j;
            if (col < dv) dv_acc[j] += pw * orow[col];
            if (col < d) dk_acc[j] += dw * qrow[col];
          }
        }
      }
    }
  }

  if (key_valid) {
    const long long row = (long long)bkv * a.kn + ki;
    T* dk = static_cast<T*>(a.out0) + row * d;
    T* dvo = static_cast<T*>(a.out1) + row * dv;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c0 + 4 * j;
      if (col < d) store(dk + col, a.scale * dk_acc[j]);
      if (col < dv) store(dvo + col, dv_acc[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (attn_mma.cuh), every product a warpgroup
// wgmma. Tiles of 64 rows in shared memory in wgmma's 128-byte swizzled
// layout (64-column blocks, D and Dv zero-filled to 64 or 128); the walked
// tiles in two stages, one filled by cp.async while the other is used. The
// forward and dq: one warpgroup (4 warps), the 64 query rows of the
// sub-tile; dk / dv: two, each the 64 keys against one half of the walked
// query sub-tile, so that the halves run at once and a key tile that many
// query tiles attend (the sinks) takes half as long; the halves' sums meet
// in shared memory at the end (no atomics, one rounding).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128, kDkvThreads = 256;
using attn_mma::bf16;

// Where a block's walk stands: the run's entry (for dk / dv, the group's
// heads times the run: head ge / ne, entry ge % ne), the walked sub-tile's
// rows [start, end) and the entry's flag.
struct Walk {
  int ge, start, end, flag;
};

// Moves w to the first sub-tile at or after it that may hold a live pair
// with this block's own rows [own0, own1] (queries for the forward and dq,
// keys for dk / dv; `by_key`: the walk is over query sub-tiles). start < 0
// enters an entry at its first sub-tile. Block-uniform; false past the
// walk's end (total entries from e0, ne a head).
__device__ __forceinline__ bool seek(const Args& a, bool by_key, int e0, int ne, int total,
                                     int own0, int own1, Walk& w) {
  for (; w.ge < total; ++w.ge, w.start = -1) {
    const int* ent = a.map + (long long)(e0 + w.ge % ne) * kWidth;
    const int flag = ent[kFlag];
    const int size = by_key ? a.block_q : a.block_k;
    const int blk_end = ((by_key ? ent[kQI] : ent[kKB]) + 1) * size;
    if (w.start < 0) w.start = blk_end - size;
    for (; w.start < blk_end; w.start += kT) {
      w.end = min(w.start + kT, blk_end);
      if (by_key ? tile_live(a, flag, w.start, w.end - 1, own0, own1)
                 : tile_live(a, flag, own0, own1, w.start, w.end - 1)) {
        w.flag = flag;
        return true;
      }
    }
  }
  return false;
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, 2) sparse_fwd_wgmma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int kTile = kT * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = swizzle_base(smem_raw);  // kT x DMAX
  bf16* ks = qs + kTile;              // 2 stages
  bf16* vs = ks + 2 * kTile;          // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int tiles = (a.block_q + kT - 1) / kT;
  const int qb = blockIdx.x / tiles;
  const int q_start = qb * a.block_q + (blockIdx.x % tiles) * kT;
  const int q_end = min(q_start + kT, (qb + 1) * a.block_q);
  const int row0 = q_start + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int e0 = a.ptr[qb], ne = a.ptr[qb + 1] - e0;

  float o[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  Walk cur{0, -1, 0, 0};
  bool have = seek(a, false, e0, ne, ne, q_start, q_end - 1, cur);
  if (have) {
    load_tile_sw128<kT, DMAX, kMmaThreads>(qs, qp, a.sq.n, q_start, q_end, a.d);
    load_tile_sw128<kT, DMAX, kMmaThreads>(ks, kp, a.sk.n, cur.start, cur.end, a.d);
    load_tile_sw128<kT, DMAX, kMmaThreads>(vs, vp, a.sv.n, cur.start, cur.end, a.dv);
  }
  cp_async_commit();
  for (int stage = 0; have; stage ^= 1) {
    Walk nxt = cur;
    nxt.start += kT;
    const bool more = seek(a, false, e0, ne, ne, q_start, q_end - 1, nxt);
    if (more) {  // the next tile's copy runs during this tile's products
      load_tile_sw128<kT, DMAX, kMmaThreads>(ks + (stage ^ 1) * kTile, kp, a.sk.n, nxt.start,
                                             nxt.end, a.d);
      load_tile_sw128<kT, DMAX, kMmaThreads>(vs + (stage ^ 1) * kTile, vp, a.sv.n, nxt.start,
                                             nxt.end, a.dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* kt = ks + stage * kTile;
    const bf16* vt = vs + stage * kTile;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma_ss_n64(s, desc_k<kT>(qs, 0, kk), desc_k<kT>(kt, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<8>(s);

    const bool full = cur.end - cur.start == kT && q_end - q_start == kT &&
                      tile_full(a, cur.flag, q_start, q_end - 1, cur.start, cur.end - 1);
    uint32_t live = ~0u;  // bit 4 j + e: element e of n-tile j is a kept pair
    if (!full) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = cur.start + j * 8 + 2 * t + (e & 1), qi = row0 + (e / 2) * 8;
          if (key < cur.end && keep_pair(a, cur.flag, qi, key)) live |= 1u << (4 * j + e);
        }
    }
    float mt[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = live >> (4 * j + e) & 1u ? s[j][e] * a.scale : kMasked;
        mt[e / 2] = fmaxf(mt[e / 2], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e / 2]);  // p, rounded to bf16 below for PV
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DMAX>(o, pa[kk], desc_mn<kT>(vt, kk * 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(o);
    fence_frags<4>(pa);
    __syncthreads();  // this stage is read; the next iteration refills it
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= q_end) continue;
    // m_run is still the masked value only when no key of the row was live.
    const bool none = m_run[r] == kMasked;
    const float l = fmaxf(l_run[r], 1e-30f);
    const long long row = (long long)bh * a.n + qi;
    bf16* orow = static_cast<bf16*>(a.out0) + row * a.dv;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      store_pair(orow, j * 8 + 2 * t, a.dv, none ? 0.f : o[j][2 * r] / l,
                 none ? 0.f : o[j][2 * r + 1] / l);
    if (t == 0) static_cast<float*>(a.out1)[row] = none ? kMasked : m_run[r] + logf(l);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, 2) sparse_dq_wgmma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int kTile = kT * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = swizzle_base(smem_raw);  // kT x DMAX
  bf16* dos = qs + kTile;             // kT x DMAX
  bf16* ks = dos + kTile;             // 2 stages
  bf16* vs = ks + 2 * kTile;          // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int bh = blockIdx.y, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int tiles = (a.block_q + kT - 1) / kT;
  const int qb = blockIdx.x / tiles;
  const int q_start = qb * a.block_q + (blockIdx.x % tiles) * kT;
  const int q_end = min(q_start + kT, (qb + 1) * a.block_q);
  const int row0 = q_start + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < q_end;
    const long long row = (long long)bh * a.n + row0 + 8 * r;
    row_lse[r] = ok ? a.lse[row] : 0.f;
    row_delta[r] = ok ? a.delta[row] : 0.f;
  }
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h;
  const bf16* op = static_cast<const bf16*>(a.dout) + b * a.so.b + hq * a.so.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int e0 = a.ptr[qb], ne = a.ptr[qb + 1] - e0;

  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  Walk cur{0, -1, 0, 0};
  bool have = seek(a, false, e0, ne, ne, q_start, q_end - 1, cur);
  if (have) {
    load_tile_sw128<kT, DMAX, kMmaThreads>(qs, qp, a.sq.n, q_start, q_end, a.d);
    load_tile_sw128<kT, DMAX, kMmaThreads>(dos, op, a.so.n, q_start, q_end, a.dv);
    load_tile_sw128<kT, DMAX, kMmaThreads>(ks, kp, a.sk.n, cur.start, cur.end, a.d);
    load_tile_sw128<kT, DMAX, kMmaThreads>(vs, vp, a.sv.n, cur.start, cur.end, a.dv);
  }
  cp_async_commit();
  for (int stage = 0; have; stage ^= 1) {
    Walk nxt = cur;
    nxt.start += kT;
    const bool more = seek(a, false, e0, ne, ne, q_start, q_end - 1, nxt);
    if (more) {
      load_tile_sw128<kT, DMAX, kMmaThreads>(ks + (stage ^ 1) * kTile, kp, a.sk.n, nxt.start,
                                             nxt.end, a.d);
      load_tile_sw128<kT, DMAX, kMmaThreads>(vs + (stage ^ 1) * kTile, vp, a.sv.n, nxt.start,
                                             nxt.end, a.dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* kt = ks + stage * kTile;
    const bf16* vt = vs + stage * kTile;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      wgmma_ss_n64(s, desc_k<kT>(qs, 0, kk), desc_k<kT>(kt, 0, kk));
      wgmma_ss_n64(dp, desc_k<kT>(dos, 0, kk), desc_k<kT>(vt, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<8>(s);
    fence_frags<8>(dp);

    const bool full = cur.end - cur.start == kT && q_end - q_start == kT &&
                      tile_full(a, cur.flag, q_start, q_end - 1, cur.start, cur.end - 1);
    uint32_t live = ~0u;  // bit 4 j + e: element e of n-tile j is a kept pair
    if (!full) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = cur.start + j * 8 + 2 * t + (e & 1), qi = row0 + (e / 2) * 8;
          if (qi < q_end && key < cur.end && keep_pair(a, cur.flag, qi, key))
            live |= 1u << (4 * j + e);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // exp(-inf) = 0 for a masked pair: no branch around the expf.
        const float p = expf(live >> (4 * j + e) & 1u ? s[j][e] * a.scale - row_lse[e / 2]
                                                      : -INFINITY);
        s[j][e] = p * (dp[j][e] - row_delta[e / 2]);  // ds, rounded to bf16 below
      }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DMAX>(acc, da[kk], desc_mn<kT>(kt, kk * 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(acc);
    fence_frags<4>(da);
    __syncthreads();
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= q_end) continue;
    bf16* out = static_cast<bf16*>(a.out0) + ((long long)bh * a.n + qi) * a.d;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      store_pair(out, j * 8 + 2 * t, a.d, a.scale * acc[j][2 * r],
                 a.scale * acc[j][2 * r + 1]);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kDkvThreads, 1) sparse_dkv_wgmma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int kTile = kT * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = swizzle_base(smem_raw);  // kT x DMAX
  bf16* vs = ks + kTile;              // kT x DMAX
  bf16* qs = vs + kTile;              // 2 stages
  bf16* dos = qs + 2 * kTile;         // 2 stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile);  // 2 stages of kT
  float* delta_s = lse_s + 2 * kT;                            // 2 stages of kT

  // Warpgroup `half` (warps 4 half .. 4 half + 3) takes the 64 keys against
  // queries 32 half .. 32 half + 31 of each walked sub-tile; its warp w % 4
  // holds keys 16 (w % 4) .. + 15 of the products.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int kw = warp % 4, half = warp / 4;
  // The KV head is the grid's fast axis (see the launch).
  const int bkv = blockIdx.x, b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.h / a.hkv;
  const int tiles = (a.block_k + kT - 1) / kT;
  const int kb = blockIdx.y / tiles;
  const int k_start = kb * a.block_k + (blockIdx.y % tiles) * kT;
  const int k_end = min(k_start + kT, (kb + 1) * a.block_k);
  const int key0 = k_start + kw * 16 + lane / 4;  // keys key0 and key0 + 8
  const int e0 = a.ptr[kb], ne = a.ptr[kb + 1] - e0;

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Q, dO, lse and delta of the walked query sub-tile w into stage st.
  auto load_q = [&](const Walk& w, int st) {
    const int hq = hk * group + w.ge / ne;
    const long long bh = (long long)b * a.h + hq;
    load_tile_sw128<kT, DMAX, kDkvThreads>(
        qs + st * kTile, static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h, a.sq.n,
        w.start, w.end, a.d);
    load_tile_sw128<kT, DMAX, kDkvThreads>(
        dos + st * kTile, static_cast<const bf16*>(a.dout) + b * a.so.b + hq * a.so.h,
        a.so.n, w.start, w.end, a.dv);
    if (threadIdx.x < 2 * kT) {
      const int i = threadIdx.x % kT, row = w.start + i;
      const float* src = (threadIdx.x < kT ? a.lse : a.delta) + bh * a.n;
      float* dst = (threadIdx.x < kT ? lse_s : delta_s) + st * kT + i;
      cp_async4(dst, row < w.end ? src + row : src, row < w.end ? 4 : 0);
    }
  };

  // An unattended key block (ne == 0) walks nothing, reads neither K nor
  // V, and writes zeros.
  Walk cur{0, -1, 0, 0};
  bool have = seek(a, true, e0, ne, group * ne, k_start, k_end - 1, cur);
  if (have) {
    load_tile_sw128<kT, DMAX, kDkvThreads>(
        ks, static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.n, k_start, k_end,
        a.d);
    load_tile_sw128<kT, DMAX, kDkvThreads>(
        vs, static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.n, k_start, k_end,
        a.dv);
    load_q(cur, 0);
  }
  cp_async_commit();
  for (int stage = 0; have; stage ^= 1) {
    Walk nxt = cur;
    nxt.start += kT;
    const bool more = seek(a, true, e0, ne, group * ne, k_start, k_end - 1, nxt);
    if (more) load_q(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* qt = qs + stage * kTile;
    const bf16* ot = dos + stage * kTile;
    const float* lse_t = lse_s + stage * kT + half * 32;
    const float* delta_t = delta_s + stage * kT + half * 32;
    const bool full = cur.end - cur.start == kT && k_end - k_start == kT &&
                      tile_full(a, cur.flag, cur.start, cur.end - 1, k_start, k_end - 1);

    // S^T and dP^T (64 keys x this half's 32 queries), P^T and dS^T in place.
    float st_[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      wgmma_ss_n32(st_, desc_k<kT>(ks, 0, kk), desc_k<kT>(qt, half * 32, kk));
      wgmma_ss_n32(dpt, desc_k<kT>(vs, 0, kk), desc_k<kT>(ot, half * 32, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<4>(st_);
    fence_frags<4>(dpt);
    uint32_t live = ~0u;  // bit 4 j + e: element e of n-tile j is a kept pair
    if (!full) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = cur.start + half * 32 + j * 8 + 2 * t + (e & 1);
          const int ki = key0 + (e / 2) * 8;
          if (ki < k_end && qi < cur.end && keep_pair(a, cur.flag, qi, ki))
            live |= 1u << (4 * j + e);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);  // the query's column of the half
        const float p =  // exp(-inf) = 0 for a masked pair: no branch around the expf
            expf(live >> (4 * j + e) & 1u ? st_[j][e] * a.scale - lse_t[c] : -INFINITY);
        st_[j][e] = p;                              // rounded for dV below
        dpt[j][e] = p * (dpt[j][e] - delta_t[c]);  // ds, rounded for dK below
      }
    uint32_t pa[2][4], da[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pack_a(pa[kk], st_[2 * kk], st_[2 * kk + 1]);
      pack_a(da[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_rs<DMAX>(dv_acc, pa[kk], desc_mn<kT>(ot, half * 32 + kk * 16));
      wgmma_rs<DMAX>(dk_acc, da[kk], desc_mn<kT>(qt, half * 32 + kk * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(dv_acc);
    fence_frags<kNt>(dk_acc);
    fence_frags<2>(pa);
    fence_frags<2>(da);
    __syncthreads();  // this stage is read; the next iteration refills it
    cur = nxt;
    have = more;
  }
  cp_async_wait<0>();
  __syncthreads();

  // The second query half's sums, through the stages (free now), onto the
  // first's: the same fragment slots, one float per thread and slot.
  float* red = reinterpret_cast<float*>(qs);  // 2 kNt 4 x 128 floats: 4 tiles
  const int slot = kw * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[((2 * j) * 4 + e) * 128 + slot] = dk_acc[j][e];
        red[((2 * j + 1) * 4 + e) * 128 + slot] = dv_acc[j][e];
      }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] += red[((2 * j) * 4 + e) * 128 + slot];
      dv_acc[j][e] += red[((2 * j + 1) * 4 + e) * 128 + slot];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = key0 + r * 8;
    if (ki >= k_end) continue;
    const long long row = (long long)bkv * a.kn + ki;
    bf16* dk = static_cast<bf16*>(a.out0) + row * a.d;
    bf16* dvo = static_cast<bf16*>(a.out1) + row * a.dv;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      store_pair(dk, j * 8 + 2 * t, a.d, a.scale * dk_acc[j][2 * r],
                 a.scale * dk_acc[j][2 * r + 1]);
      store_pair(dvo, j * 8 + 2 * t, a.dv, dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

enum Which { kFwd, kDq, kDkv };

size_t smem_bytes(Which w, int d, int dv) {
  const size_t qd = (size_t)kT * (d + 1), vd = (size_t)kT * (dv + 1),
               pt = (size_t)kT * (kT + 1);
  if (w == kFwd) return sizeof(float) * (2 * qd + vd + pt);
  if (w == kDq) return sizeof(float) * (2 * qd + 2 * vd + pt);
  return sizeof(float) * (2 * qd + 2 * vd + 2 * pt + 2 * kT);
}

// Shared memory of the bf16 kernels, whose tiles are all DMAX wide, plus
// 1 KB to align them: the forward's Q and two stages of K and V (81 KB at
// DMAX 128, two blocks an SM); dq's Q, dO and two stages of K and V (97
// KB, two blocks); dk / dv's K, V, two stages of Q and dO and of lse and
// delta (98 KB; its two warpgroups take 213 registers a thread, so one
// block an SM).
size_t wgmma_smem_bytes(Which w, int dmax) {
  const size_t tile = sizeof(attn_mma::bf16) * kT * dmax;
  if (w == kFwd) return 5 * tile + 1024;
  return 6 * tile + (w == kDkv ? 4 * kT * sizeof(float) : 0) + 1024;
}


template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t bytes, size_t* allowed, dim3 grid,
                   const Args& a, cudaStream_t stream) {
  if (bytes > *allowed) {  // raised once per instantiation
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    *allowed = bytes;
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The forward and dq: one block per (64-query sub-tile, batch * head). dk /
// dv: key tiles on the slow axis, so that the blocks of a key tile, one per
// (batch, KV head), start together and the heavy ones first: a key tile
// that many query blocks attend (the sinks; under a causal mask the first)
// holds several times the average work, and started last it would run on
// alone after the rest of the grid is done.
dim3 grid_of(Which w, const Args& a, int b) {
  if (w == kDkv) return dim3(b * a.hkv, (a.kn / a.block_k) * ((a.block_k + kT - 1) / kT));
  return dim3((a.n / a.block_q) * ((a.block_q + kT - 1) / kT), b * a.h);
}

template <typename T, int DMAX>
cudaError_t launch_as(Which w, const Args& a, int b, cudaStream_t stream) {
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t bytes = smem_bytes(w, a.d, a.dv);
  const dim3 grid = grid_of(w, a, b);
  if (w == kDkv)
    return launch(sparse_dkv_kernel<T, DMAX>, kThreads, bytes, &allowed[w], grid, a, stream);
  if (w == kDq)
    return launch(sparse_dq_kernel<T, DMAX>, kThreads, bytes, &allowed[w], grid, a, stream);
  return launch(sparse_fwd_kernel<T, DMAX>, kThreads, bytes, &allowed[w], grid, a, stream);
}

template <typename T>
cudaError_t by_width(Which w, const Args& a, int b, cudaStream_t stream) {
  const int widest = w == kFwd ? a.dv : max(a.d, a.dv);
  if (widest <= 32) return launch_as<T, 32>(w, a, b, stream);
  if (widest <= 64) return launch_as<T, 64>(w, a, b, stream);
  if (widest <= 128) return launch_as<T, 128>(w, a, b, stream);
  return cudaErrorInvalidValue;
}

template <int DMAX>
cudaError_t launch_wgmma(Which w, const Args& a, int b, cudaStream_t stream) {
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t bytes = wgmma_smem_bytes(w, DMAX);
  const dim3 grid = grid_of(w, a, b);
  if (w == kDkv)
    return launch(sparse_dkv_wgmma_kernel<DMAX>, kDkvThreads, bytes, &allowed[w], grid, a,
                  stream);
  if (w == kDq)
    return launch(sparse_dq_wgmma_kernel<DMAX>, kMmaThreads, bytes, &allowed[w], grid, a,
                  stream);
  return launch(sparse_fwd_wgmma_kernel<DMAX>, kMmaThreads, bytes, &allowed[w], grid, a,
                stream);
}

// bf16: D and Dv both padded (zero-filled) to the width instantiated.
cudaError_t wgmma_by_width(Which w, const Args& a, int b, cudaStream_t stream) {
  const int widest = max(a.d, a.dv);
  if (widest <= 64) return launch_wgmma<64>(w, a, b, stream);
  if (widest <= 128) return launch_wgmma<128>(w, a, b, stream);
  return cudaErrorInvalidValue;
}

int entry(Which w, const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* out0, void* out1,
          const void* map, const void* ptr, int b, int h, int hkv, int n, int kn,
          int d, int dv, int block_q, int block_k, const long long* st,
          float scale, int causal, int has_window, int window,
          int global_prefix, int dtype, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv || n < 1 || kn < 1 || d < 1 ||
      d > kMaxD || dv < 1 || dv > kMaxD || block_q < 1 || block_k < 1 ||
      n % block_q || kn % block_k || !map || !ptr || (!out1 && w != kDq) ||
      (w != kFwd && (!dout || !lse || !delta)) ||
      (w != kDkv && (b * h > 65535 ||
                     (long long)n / block_q * ((block_q + kT - 1) / kT) > 0x7fffffffLL)) ||
      (w == kDkv && (long long)kn / block_k * ((block_k + kT - 1) / kT) > 65535) ||
      (dtype == 0 && smem_bytes(w, d, dv) > 227 * 1024))
    return cudaErrorInvalidValue;
  using attn_mma::runs_aligned;  // the bf16 kernels copy rows 16 bytes at a time
  if (dtype == 1 && !(runs_aligned(q, st, b, h, n, d, 3) &&
                      runs_aligned(k, st + 4, b, hkv, kn, d, 3) &&
                      runs_aligned(v, st + 8, b, hkv, kn, dv, 3) &&
                      (w == kFwd || runs_aligned(dout, st + 12, b, h, n, dv, 3))))
    return cudaErrorMisalignedAddress;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               out0, out1,
               static_cast<const int*>(map), static_cast<const int*>(ptr),
               h, hkv, n, kn, d, dv, block_q, block_k,
               Strides{st[0], st[1], st[2], st[3]}, Strides{st[4], st[5], st[6], st[7]},
               Strides{st[8], st[9], st[10], st[11]}, Strides{st[12], st[13], st[14], st[15]},
               scale, causal, has_window, window, global_prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(w, a, b, s);  // the CUDA cores, in f32
  if (dtype == 1) return wgmma_by_width(w, a, b, s);   // the tensor cores
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One signature for the three entries. dtype codes: 0 f32, 1 bf16. strides:
// 16 element strides, (batch, head, seq, dim) for each of q, k, v, dout
// (the forward ignores dout's). has_window 0: no window clause. The forward
// takes out0 = o, out1 = lse and no dout, lse or delta; dq takes out0 = dq;
// dk / dv out0 = dk, out1 = dv, with tmap and its run starts. Each returns a
// cudaError_t: cudaErrorInvalidValue for what the kernels do not take (D or
// Dv > 128, H not a multiple of Hkv, N or KN not a multiple of its block, a
// grid past 65,535 on its slow axis: B * H for the forward and dq, the key
// sub-tiles for dk / dv); cudaErrorMisalignedAddress for a bf16 tensor
// whose rows the tensor-core kernels cannot copy 16 bytes at a time (see
// attn_mma.cuh's runs_aligned).
#define KU_SPARSE_ENTRY(NAME, WHICH)                                            \
  int NAME(const void* q, const void* k, const void* v, const void* dout,       \
           const void* lse, const void* delta, void* out0, void* out1,          \
           const void* map, const void* ptr, int b, int h, int hkv, int n,      \
           int kn, int d, int dv, int block_q, int block_k,                     \
           const long long* strides, float scale, int causal, int has_window,   \
           int window, int global_prefix, int dtype, void* stream) {            \
    return entry(WHICH, q, k, v, dout, lse, delta, out0, out1, map, ptr, b, h,  \
                 hkv, n, kn, d, dv, block_q, block_k, strides, scale, causal,   \
                 has_window, window, global_prefix, dtype, stream);             \
  }

KU_SPARSE_ENTRY(sparse_fwd_launch, kFwd)
KU_SPARSE_ENTRY(sparse_bwd_dq_launch, kDq)
KU_SPARSE_ENTRY(sparse_bwd_dkv_launch, kDkv)
#undef KU_SPARSE_ENTRY

const char* sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
