// Flash-attention backward: dq, and dk / dv, recomputed tile by tile from
// the forward's saved f32 log-sum-exp.
//
// Replaces ku/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (through _bwd_pallas, :503-890).
//
// Contract (the forward's, flash_fwd.cu):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv), dout (B, H, N, Dv):
//     f32 or bf16, D and Dv <= 128; query head j reads KV head j / (H / Hkv).
//     Strides: any on the f32 route; bf16 rows unit-stride along the head
//     in 16-byte runs (runs_aligned; autograd's dO, a transposed view, is),
//     which the wrapper makes sure of by copying any other.
//   lse, delta (B, H, N) f32 contiguous: the forward's log-sum-exp and
//     delta = rowsum(dout * o) over the forward's stored (rounded) o.
//   q_off, k_off (B,) int32; seg_q (B, N), seg_k (B, KN) int32 or null.
//   dq (B, H, N, D), dk (B, Hkv, KN, D), dv (B, Hkv, KN, Dv) contiguous, in
//     the dtype of q, k and v.
// Per (query, key) pair, as ku: s = (q . k) * scale; with a softcap,
// s = cap * tanh(s / cap) and dcap = 1 - (s / cap)^2 from the capped value;
// then the forward's masks (past KN or N, another segment, the causal
// future, out of the window). p = exp(s - lse) for a live pair and 0 for a
// masked one, set explicitly: a row with no live key has lse = -1e30, and
// exp(-1e30 + 1e30) would be 1. dp = dout . v; ds = p * (dp - delta) * dcap.
// dq = scale * sum_k ds . k with ds rounded to k's dtype; dv = sum_q p . dout
// with p rounded to dout's dtype; dk = scale * sum_q ds . q with ds rounded
// to q's dtype. Every sum is f32. A row with no live key gets dq = 0 and
// adds nothing to dk or dv.
//
// What bounds it on an H100: at the training shape (B = 8, H = 16 over
// Hkv = 4, N = KN = 1,024, D = 128, causal, bf16) the live pairs are
// B * H * N (N + 1) / 2 = 67 M. The dq kernel does 6 * D operations a pair
// (s, dp, dq), 52 GFLOP, 0.05 ms at the 989 TFLOP/s bf16 tensor-core peak;
// the dk/dv kernel 8 * D (s, dp, dv, dk), 69 GFLOP, 0.07 ms; each moves
// about 0.1 GB (q, k, v, dout, lse, delta in, its gradients out), 0.03 ms
// at 3.35 TB/s: operations bound both.
//
// Two routes, chosen by dtype at the C entry; nothing falls back from one
// to the other.
// - bf16: the tensor-core kernels (flash_bwd_{dq,dkv}_wgmma_kernel, over
//   attn_mma.cuh), the design of sparse_attention.cu's: every product a
//   warpgroup wgmma, bf16 in and f32 sums. S = Q K^T and dP = dO V^T (and
//   their transposes in dk / dv) read both operands from shared memory;
//   dQ += dS K, dV += P^T dO and dK += dS^T Q take A in registers (p or ds
//   rounded to bf16 by pack_a) and read B transposed. Tiles sit in wgmma's
//   128-byte swizzled layout, filled by 16-byte cp.async copies that
//   zero-fill rows past N or KN and columns past D or Dv. The walked tiles
//   are double-buffered (K and V for dq; Q, dO, lse and delta for dk / dv),
//   the next copied during this one's products. A tile whose corners pass
//   every clause of the mask tests no pair; any other builds a bitmask of
//   its live pairs once, and a masked pair's exp takes -inf.
//   - dq: one warpgroup per (batch * head, 64-query tile), two blocks an
//     SM; it walks the live key tiles (the forward's rule) with dq in f32
//     registers. Under a causal mask query tile i walks i + 1 key tiles, so
//     the grid starts the last query tiles first. Shared memory: Q, dO and
//     two stages of K and V, 6 * 64 * DMAX bf16 + 1 KB, 97 KB at DMAX 128.
//   - dk / dv: two warpgroups per (batch * KV head, 64-key tile), each the
//     64 keys against one half of every walked 64-query tile, one block an
//     SM; the block walks the live query tiles of EVERY query head of its
//     group, summing the group in registers (ku's per-query-head partials
//     and their f32 sum, :882-890, without atomics: one rounding, the same
//     order every run); the halves' sums meet in shared memory at the end.
//     Key tile j is walked by the query tiles from j on under a causal
//     mask, so the key tiles run from the first, with the KV head on the
//     grid's fast axis so that a tile's blocks start together. Shared
//     memory: K, V and two stages of Q, dO, lse and delta, 6 * 64 * DMAX
//     bf16 + 1 KB + 1 KB, 98 KB at DMAX 128.
//   Their times at the training shape and their registers are in PERF.md.
// - f32: the CUDA-core kernels (flash_bwd_{dq,dkv}_kernel), kept from
//   before the tensor cores because TF32 would miss the f32 comparisons at
//   1e-4: 256 threads a block, 64 x 64 tiles staged through shared memory
//   as f32 from any strides, the same grids and walks. Thread t owns row
//   t / 4 of the block's own tile (queries for dq, keys for dk / dv) and
//   columns t % 4 + 4 j of the walked one: it computes their scores and dp
//   in registers, writes ds (and p) to shared tiles, and accumulates D / 4
//   columns of its gradients in f32 registers. Rows are padded to D + 1
//   and 65 words so that the 8 rows a warp reads lie on distinct banks.
//   Shared memory at D = Dv = 128: dq 149 KB, dk / dv 166 KB. The f32 FMA
//   and shared-memory rate bound them, at 120-160x the operation bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kBq = 64, kBk = 64, kThreads = 256;
constexpr int kCols = 64 / 4;  // pairs of a tile row one thread computes
constexpr int kMaxD = 128;     // widest head instantiated (D and Dv)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct Strides {
  long long b, h, n, d;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  const int *q_off, *k_off, *seg_q, *seg_k;
  int h, hkv, n, kn, d, dv;
  Strides sq, sk, sv, so;
  float scale, softcap;
  int causal, window;
};

// As flash_fwd.cu: stage rows [row0, row0 + rows) x [0, cols) of a strided
// (n, cols) slab into dst (leading dimension ld) as f32, zero past n, the
// loop along the unit-stride axis so that neighbouring threads read
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long sn, long long sd, int row0,
                                      int rows, int n, int cols) {
  const int total = rows * cols;
  if (sd == 1 || sn != 1) {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int r = e / cols, c = e % cols;
      const int row = row0 + r;
      dst[r * ld + c] = row < n ? to_f32(src[row * sn + c * sd]) : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int c = e / rows, r = e % rows;
      const int row = row0 + r;
      dst[r * ld + c] = row < n ? to_f32(src[row * sn + c * sd]) : 0.f;
    }
  }
}

// The pair's live test and its capped score: returns false for a masked
// pair. qpos / kpos are global positions, qi / ki indices in the sequence.
__device__ __forceinline__ bool live_pair(const Args& a, int qi, int ki,
                                          int qpos, int kpos, int sq_id,
                                          int sk_id) {
  bool keep = qi < a.n && ki < a.kn;
  if (a.seg_q) keep = keep && sq_id == sk_id;
  if (a.causal) keep = keep && kpos <= qpos;
  if (a.window > 0) keep = keep && qpos - kpos < a.window;
  return keep;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv;
  const int ldq = d + 1, ldv = dv + 1, ldp = kBk + 1;
  float* qs = smem;               // kBq x ldq
  float* dos = qs + kBq * ldq;    // kBq x ldv
  float* ks = dos + kBq * ldv;    // kBk x ldq
  float* vs = ks + kBk * ldq;     // kBk x ldv
  float* dss = vs + kBk * ldv;    // kBq x ldp
  int* segk = reinterpret_cast<int*>(dss + kBq * ldp);  // kBk

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  const int bh = blockIdx.y, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int q_start = blockIdx.x * kBq;
  const int q_last = min(q_start + kBq, a.n) - 1;
  const int qo = a.q_off[b], ko = a.k_off[b];
  const int qi = q_start + r;
  const bool row_valid = qi < a.n;
  const long long row = (long long)bh * a.n + qi;
  const int my_seg = (a.seg_q && row_valid) ? a.seg_q[(long long)b * a.n + qi] : 0;
  const float row_lse = row_valid ? a.lse[row] : 0.f;
  const float row_delta = row_valid ? a.delta[row] : 0.f;

  const T* qb = q + b * a.sq.b + hq * a.sq.h;
  const T* ob = dout + b * a.so.b + hq * a.so.h;
  const T* kb = k + b * a.sk.b + hk * a.sk.h;
  const T* vb = v + b * a.sv.b + hk * a.sv.h;

  // Live key tiles, the forward's rule: at or below the causal edge of the
  // tile's last query, at or above the window's lower edge of its first.
  int kb_lo = 0, kb_hi = (a.kn + kBk - 1) / kBk;
  if (a.causal) {
    const int kmax = qo + q_last - ko;
    kb_hi = kmax < 0 ? 0 : min(kb_hi, kmax / kBk + 1);
  }
  if (a.window > 0)
    kb_lo = max(0, floor_div(qo + q_start - (a.window - 1) - ko, kBk));

  stage(qs, ldq, qb, a.sq.n, a.sq.d, q_start, kBq, a.n, d);
  stage(dos, ldv, ob, a.so.n, a.so.d, q_start, kBq, a.n, dv);

  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  for (int t = kb_lo; t < kb_hi; ++t) {
    const int k_start = t * kBk;
    __syncthreads();  // the previous tile is done with ks, vs, dss
    stage(ks, ldq, kb, a.sk.n, a.sk.d, k_start, kBk, a.kn, d);
    stage(vs, ldv, vb, a.sv.n, a.sv.d, k_start, kBk, a.kn, dv);
    if (a.seg_k && tid < kBk)
      segk[tid] = k_start + tid < a.kn ? a.seg_k[(long long)b * a.kn + k_start + tid] : -1;
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
      float x = s[j] * a.scale, dcap = 1.f;
      if (a.softcap > 0.f) {
        x = a.softcap * tanhf(x / a.softcap);
        const float y = x / a.softcap;
        dcap = 1.f - y * y;
      }
      const bool keep = live_pair(a, qi, key, qo + qi, ko + key, my_seg,
                                  a.seg_k ? segk[c] : 0);
      const float p = keep ? expf(x - row_lse) : 0.f;
      float ds = p * (dp[j] - row_delta);
      if (a.softcap > 0.f) ds *= dcap;
      dss[r * ldp + c] = round_as(ds, k);
    }
    __syncwarp();  // row r of dss is written and read by the same 4 threads

    const float* drow = dss + r * ldp;
    for (int c = 0; c < kBk; ++c) {
      const float w = drow[c];
      const float* krow = ks + c * ldq;
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) {
        const int col = c0 + 4 * j;
        if (col < d) acc[j] += w * krow[col];
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
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, dv = a.dv;
  const int ldq = d + 1, ldv = dv + 1, ldp = kBq + 1;
  float* ks = smem;               // kBk x ldq
  float* vs = ks + kBk * ldq;     // kBk x ldv
  float* qs = vs + kBk * ldv;     // kBq x ldq
  float* dos = qs + kBq * ldq;    // kBq x ldv
  float* ps = dos + kBq * ldv;    // kBk x ldp
  float* dss = ps + kBk * ldp;    // kBk x ldp
  float* lse_s = dss + kBk * ldp; // kBq
  float* delta_s = lse_s + kBq;   // kBq
  int* segq = reinterpret_cast<int*>(delta_s + kBq);  // kBq

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  const int bkv = blockIdx.y, b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.h / a.hkv;
  const int k_start = blockIdx.x * kBk;
  const int k_last = min(k_start + kBk, a.kn) - 1;
  const int qo = a.q_off[b], ko = a.k_off[b];
  const int ki = k_start + r;
  const bool key_valid = ki < a.kn;
  const int my_seg = (a.seg_k && key_valid) ? a.seg_k[(long long)b * a.kn + ki] : 0;

  stage(ks, ldq, k + b * a.sk.b + hk * a.sk.h, a.sk.n, a.sk.d, k_start, kBk, a.kn, d);
  stage(vs, ldv, v + b * a.sv.b + hk * a.sv.h, a.sv.n, a.sv.d, k_start, kBk, a.kn, dv);

  // Live query tiles, the same rule read from the key side: at or past the
  // first query that sees the tile's first key (causal), at or before the
  // last query whose window still holds the tile's last key.
  int qb_lo = 0, qb_hi = (a.n + kBq - 1) / kBq;
  if (a.causal) qb_lo = max(0, floor_div(ko + k_start - qo, kBq));
  if (a.window > 0) {
    const int qmax = a.window - 1 + ko + k_last - qo;
    qb_hi = qmax < 0 ? 0 : min(qb_hi, qmax / kBq + 1);
  }

  float dk_acc[DMAX / 4], dv_acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const long long bh = (long long)b * a.h + hq;
    const T* qb = q + b * a.sq.b + hq * a.sq.h;
    const T* ob = dout + b * a.so.b + hq * a.so.h;
    for (int t = qb_lo; t < qb_hi; ++t) {
      const int q_start = t * kBq;
      __syncthreads();  // the previous tile is done with qs, dos, ps, dss
      stage(qs, ldq, qb, a.sq.n, a.sq.d, q_start, kBq, a.n, d);
      stage(dos, ldv, ob, a.so.n, a.so.d, q_start, kBq, a.n, dv);
      if (tid < kBq) {
        const int row = q_start + tid;
        const bool ok = row < a.n;
        lse_s[tid] = ok ? a.lse[bh * a.n + row] : 0.f;
        delta_s[tid] = ok ? a.delta[bh * a.n + row] : 0.f;
        segq[tid] = (a.seg_q && ok) ? a.seg_q[(long long)b * a.n + row] : -1;
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
        float x = s[j] * a.scale, dcap = 1.f;
        if (a.softcap > 0.f) {
          x = a.softcap * tanhf(x / a.softcap);
          const float y = x / a.softcap;
          dcap = 1.f - y * y;
        }
        const bool keep = live_pair(a, qi, ki, qo + qi, ko + ki, segq[c], my_seg);
        const float p = keep ? expf(x - lse_s[c]) : 0.f;
        float ds = p * (dp[j] - delta_s[c]);
        if (a.softcap > 0.f) ds *= dcap;
        ps[r * ldp + c] = round_as(p, dout);
        dss[r * ldp + c] = round_as(ds, q);
      }
      __syncwarp();  // rows r of ps and dss: written and read by 4 threads

      const float* prow = ps + r * ldp;
      const float* drow = dss + r * ldp;
      for (int c = 0; c < kBq; ++c) {
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
// bf16: the tensor-core kernels (see the head of the file).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128, kDkvThreads = 256;
using attn_mma::bf16;

__device__ __forceinline__ attn_mma::DenseMask mask_of(const Args& a, int b) {
  return {a.n, a.kn, a.q_off[b], a.k_off[b], a.causal, a.window,
          a.seg_q ? a.seg_q + (long long)b * a.n : nullptr,
          a.seg_k ? a.seg_k + (long long)b * a.kn : nullptr};
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_bwd_dq_wgmma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int kTile = kBq * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = swizzle_base(smem_raw);  // kBq x DMAX
  bf16* dos = qs + kTile;             // kBq x DMAX
  bf16* ks = dos + kTile;             // 2 stages of kBk x DMAX
  bf16* vs = ks + 2 * kTile;          // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  // The (batch * head) is the grid's fast axis and the query tiles run from
  // the last: under a causal mask the last tiles walk the most keys.
  const int bh = blockIdx.x, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int q_end = min(q_start + kBq, a.n);
  const int row0 = q_start + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const DenseMask mask = mask_of(a, b);
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
  int kt_lo, kt_hi;
  mask.key_tiles(q_start, q_end - 1, kt_lo, kt_hi);

  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (kt_lo < kt_hi) {
    load_tile_sw128<kBq, DMAX, kMmaThreads>(qs, qp, a.sq.n, q_start, a.n, a.d);
    load_tile_sw128<kBq, DMAX, kMmaThreads>(dos, op, a.so.n, q_start, a.n, a.dv);
    load_tile_sw128<kBk, DMAX, kMmaThreads>(ks, kp, a.sk.n, kt_lo * kBk, a.kn, a.d);
    load_tile_sw128<kBk, DMAX, kMmaThreads>(vs, vp, a.sv.n, kt_lo * kBk, a.kn, a.dv);
  }
  cp_async_commit();
  for (int tile = kt_lo, stage = 0; tile < kt_hi; ++tile, stage ^= 1) {
    if (tile + 1 < kt_hi) {  // the next tile's copy runs during these products
      load_tile_sw128<kBk, DMAX, kMmaThreads>(ks + (stage ^ 1) * kTile, kp, a.sk.n,
                                              (tile + 1) * kBk, a.kn, a.d);
      load_tile_sw128<kBk, DMAX, kMmaThreads>(vs + (stage ^ 1) * kTile, vp, a.sv.n,
                                              (tile + 1) * kBk, a.kn, a.dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* kt = ks + stage * kTile;
    const bf16* vt = vs + stage * kTile;
    const int k_start = tile * kBk;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      wgmma_ss_n64(s, desc_k<kBq>(qs, 0, kk), desc_k<kBk>(kt, 0, kk));
      wgmma_ss_n64(dp, desc_k<kBq>(dos, 0, kk), desc_k<kBk>(vt, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<8>(s);
    fence_frags<8>(dp);

    uint32_t live = ~0u;  // bit 4 j + e: element e of n-tile j is a live pair
    if (!mask.full(q_start, k_start)) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (mask.pair(row0 + (e / 2) * 8, k_start + j * 8 + 2 * t + (e & 1)))
            live |= 1u << (4 * j + e);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        const float x = capped(s[j][e] * a.scale, a.softcap, dcap);
        // exp(-inf) = 0 for a masked pair: no branch around the expf.
        const float p = expf(live >> (4 * j + e) & 1u ? x - row_lse[e / 2] : -INFINITY);
        s[j][e] = p * (dp[j][e] - row_delta[e / 2]) * dcap;  // ds, rounded to bf16 below
      }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DMAX>(acc, da[kk], desc_mn<kBk>(kt, kk * 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(acc);
    fence_frags<4>(da);
    __syncthreads();  // this stage is read; the next iteration refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= q_end) continue;
    bf16* out = static_cast<bf16*>(a.out0) + ((long long)bh * a.n + qi) * a.d;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      store_pair(out, j * 8 + 2 * t, a.d, a.scale * acc[j][2 * r], a.scale * acc[j][2 * r + 1]);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kDkvThreads, 1) flash_bwd_dkv_wgmma_kernel(Args a) {
  using namespace attn_mma;
  constexpr int kTile = kBk * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = swizzle_base(smem_raw);  // kBk x DMAX
  bf16* vs = ks + kTile;              // kBk x DMAX
  bf16* qs = vs + kTile;              // 2 stages of kBq x DMAX
  bf16* dos = qs + 2 * kTile;         // 2 stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile);  // 2 stages of kBq
  float* delta_s = lse_s + 2 * kBq;                           // 2 stages of kBq

  // Warpgroup `half` (warps 4 half .. 4 half + 3) takes the 64 keys against
  // queries 32 half .. 32 half + 31 of each walked query tile; its warp
  // w % 4 holds keys 16 (w % 4) .. + 15 of the products.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int kw = warp % 4, half = warp / 4;
  // The KV head is the grid's fast axis and the key tiles run from the
  // first: under a causal mask the first tiles are walked the most.
  const int bkv = blockIdx.x, b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.h / a.hkv;
  const int k_start = blockIdx.y * kBk;
  const int k_end = min(k_start + kBk, a.kn);
  const int key0 = k_start + kw * 16 + lane / 4;  // keys key0 and key0 + 8
  const DenseMask mask = mask_of(a, b);
  int qt_lo, qt_hi;
  mask.query_tiles(k_start, k_end - 1, qt_lo, qt_hi);
  // The walk: query tile qt_lo + w % nq of the group's head w / nq.
  const int nq = max(0, qt_hi - qt_lo), total = group * nq;

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Q, dO, lse and delta of step w of the walk into stage st.
  auto load_q = [&](int w, int st) {
    const int hq = hk * group + w / nq, q0 = (qt_lo + w % nq) * kBq;
    const long long bh = (long long)b * a.h + hq;
    load_tile_sw128<kBq, DMAX, kDkvThreads>(
        qs + st * kTile, static_cast<const bf16*>(a.q) + b * a.sq.b + hq * a.sq.h, a.sq.n, q0,
        a.n, a.d);
    load_tile_sw128<kBq, DMAX, kDkvThreads>(
        dos + st * kTile, static_cast<const bf16*>(a.dout) + b * a.so.b + hq * a.so.h, a.so.n,
        q0, a.n, a.dv);
    if (threadIdx.x < 2 * kBq) {
      const int i = threadIdx.x % kBq, row = q0 + i;
      const float* src = (threadIdx.x < kBq ? a.lse : a.delta) + bh * a.n;
      float* dst = (threadIdx.x < kBq ? lse_s : delta_s) + st * kBq + i;
      cp_async4(dst, row < a.n ? src + row : src, row < a.n ? 4 : 0);
    }
  };

  // A key tile that no query attends walks nothing, reads neither K nor V,
  // and writes zeros.
  if (total > 0) {
    load_tile_sw128<kBk, DMAX, kDkvThreads>(
        ks, static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.n, k_start, a.kn,
        a.d);
    load_tile_sw128<kBk, DMAX, kDkvThreads>(
        vs, static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.n, k_start, a.kn,
        a.dv);
    load_q(0, 0);
  }
  cp_async_commit();
  for (int w = 0, stage = 0; w < total; ++w, stage ^= 1) {
    if (w + 1 < total) load_q(w + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const int q_start = (qt_lo + w % nq) * kBq;
    const bf16* qt = qs + stage * kTile;
    const bf16* ot = dos + stage * kTile;
    const float* lse_t = lse_s + stage * kBq + half * 32;
    const float* delta_t = delta_s + stage * kBq + half * 32;

    // S^T and dP^T (64 keys x this half's 32 queries), P^T and dS^T in place.
    float st_[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      wgmma_ss_n32(st_, desc_k<kBk>(ks, 0, kk), desc_k<kBq>(qt, half * 32, kk));
      wgmma_ss_n32(dpt, desc_k<kBk>(vs, 0, kk), desc_k<kBq>(ot, half * 32, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<4>(st_);
    fence_frags<4>(dpt);
    uint32_t live = ~0u;  // bit 4 j + e: element e of n-tile j is a live pair
    if (!mask.full(q_start, k_start)) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (mask.pair(q_start + half * 32 + j * 8 + 2 * t + (e & 1), key0 + (e / 2) * 8))
            live |= 1u << (4 * j + e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);  // the query's column of the half
        float dcap;
        const float x = capped(st_[j][e] * a.scale, a.softcap, dcap);
        // exp(-inf) = 0 for a masked pair: no branch around the expf.
        const float p = expf(live >> (4 * j + e) & 1u ? x - lse_t[c] : -INFINITY);
        st_[j][e] = p;                                     // rounded for dV below
        dpt[j][e] = p * (dpt[j][e] - delta_t[c]) * dcap;  // ds, rounded for dK below
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
      wgmma_rs<DMAX>(dv_acc, pa[kk], desc_mn<kBq>(ot, half * 32 + kk * 16));
      wgmma_rs<DMAX>(dk_acc, da[kk], desc_mn<kBq>(qt, half * 32 + kk * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(dv_acc);
    fence_frags<kNt>(dk_acc);
    fence_frags<2>(pa);
    fence_frags<2>(da);
    __syncthreads();  // this stage is read; the next iteration refills it
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

size_t dq_smem_bytes(int d, int dv) {
  return sizeof(float) * (2 * (size_t)kBq * (d + 1) + 2 * (size_t)kBk * (dv + 1) +
                          (size_t)kBq * (kBk + 1) + kBk);
}

size_t dkv_smem_bytes(int d, int dv) {
  return sizeof(float) * (2 * (size_t)kBk * (d + 1) + 2 * (size_t)kBq * (dv + 1) +
                          2 * (size_t)kBk * (kBq + 1) + 3 * kBq);
}

// Shared memory of the bf16 kernels, whose tiles are all DMAX wide, plus
// 1 KB to align them: dq's Q, dO and two stages of K and V; dk / dv's K, V
// and two stages of Q and dO, and of lse and delta.
size_t mma_smem_bytes(bool dkv, int dmax) {
  return 6 * sizeof(bf16) * kBq * dmax + (dkv ? 4 * kBq * sizeof(float) : 0) + 1024;
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

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a, int b, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  return launch(flash_bwd_dq_kernel<T, DMAX>, kThreads, dq_smem_bytes(a.d, a.dv), &allowed,
                dim3((a.n + kBq - 1) / kBq, b * a.h), a, stream);
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a, int b, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  return launch(flash_bwd_dkv_kernel<T, DMAX>, kThreads, dkv_smem_bytes(a.d, a.dv), &allowed,
                dim3((a.kn + kBk - 1) / kBk, b * a.hkv), a, stream);
}

template <typename T>
cudaError_t by_width(bool dkv, const Args& a, int b, cudaStream_t stream) {
  const int widest = max(a.d, a.dv);
#define KU_FLASH_BWD_LAUNCH(DM) \
  return dkv ? launch_dkv<T, DM>(a, b, stream) : launch_dq<T, DM>(a, b, stream)
  if (widest <= 32) KU_FLASH_BWD_LAUNCH(32);
  if (widest <= 64) KU_FLASH_BWD_LAUNCH(64);
  if (widest <= 128) KU_FLASH_BWD_LAUNCH(128);
#undef KU_FLASH_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

// The tensor-core kernels: one block per (batch * head, query tile), the
// query tiles on the slow axis, for dq; per (batch * KV head, key tile),
// the key tiles on the slow axis, for dk / dv.
template <int DMAX>
cudaError_t launch_mma(bool dkv, const Args& a, int b, cudaStream_t stream) {
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const size_t bytes = mma_smem_bytes(dkv, DMAX);
  if (dkv)
    return launch(flash_bwd_dkv_wgmma_kernel<DMAX>, kDkvThreads, bytes, &allowed[1],
                  dim3(b * a.hkv, (a.kn + kBk - 1) / kBk), a, stream);
  return launch(flash_bwd_dq_wgmma_kernel<DMAX>, kMmaThreads, bytes, &allowed[0],
                dim3(b * a.h, (a.n + kBq - 1) / kBq), a, stream);
}

// What the last launch that succeeded on this host thread took
// (flash_bwd_last_launch): 0 the CUDA cores, 1 the tensor cores; -1 before
// any.
thread_local int last_launch = -1;

int entry(bool dkv, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* out0,
          void* out1, const void* q_off, const void* k_off, const void* seg_q,
          const void* seg_k, int b, int h, int hkv, int n, int kn, int d,
          int dv, const long long* st, float scale, float softcap,
          int causal, int window, int dtype, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv || n < 1 || kn < 1 || d < 1 ||
      d > kMaxD || dv < 1 || dv > kMaxD || (dkv && !out1))
    return cudaErrorInvalidValue;
  if (dtype == 1 && ((dkv ? (kn + kBk - 1) / kBk : (n + kBq - 1) / kBq) > 65535))
    return cudaErrorInvalidValue;
  if (dtype != 1 && ((dkv ? b * hkv : b * h) > 65535 ||
                     (dkv ? dkv_smem_bytes(d, dv) : dq_smem_bytes(d, dv)) > 227 * 1024))
    return cudaErrorInvalidValue;
  using attn_mma::runs_aligned;  // the bf16 kernels copy rows 16 bytes at a time
  if (dtype == 1 && !(runs_aligned(q, st, b, h, n, d, 3) &&
                      runs_aligned(k, st + 4, b, hkv, kn, d, 3) &&
                      runs_aligned(v, st + 8, b, hkv, kn, dv, 3) &&
                      runs_aligned(dout, st + 12, b, h, n, dv, 3)))
    return cudaErrorMisalignedAddress;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               out0, out1,
               static_cast<const int*>(q_off), static_cast<const int*>(k_off),
               static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
               h, hkv, n, kn, d, dv,
               Strides{st[0], st[1], st[2], st[3]}, Strides{st[4], st[5], st[6], st[7]},
               Strides{st[8], st[9], st[10], st[11]}, Strides{st[12], st[13], st[14], st[15]},
               scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = by_width<float>(dkv, a, b, s);  // the CUDA cores, in f32
  else if (dtype == 1)  // the tensor cores, D and Dv zero-filled to the width instantiated
    err = max(d, dv) <= 64 ? launch_mma<64>(dkv, a, b, s) : launch_mma<128>(dkv, a, b, s);
  else
    return cudaErrorInvalidValue;
  if (err == cudaSuccess) last_launch = dtype;
  return err;
}

}  // namespace

extern "C" {

// dtype codes: 0 f32 (the CUDA-core kernels), 1 bf16 (the tensor-core
// ones). strides: 16 element strides, (batch, head, seq, dim) for each of
// q, k, v, dout. window <= 0: none; softcap <= 0: none. out1 is unused by
// the dq entry. Each returns a cudaError_t: cudaErrorInvalidValue for
// shapes the kernels do not take (D or Dv > 128, H not a multiple of Hkv,
// a grid past 65,535 rows on its slow axis); cudaErrorMisalignedAddress for
// a bf16 tensor whose rows the tensor-core kernels cannot copy 16 bytes at
// a time (attn_mma.cuh's runs_aligned).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* unused, const void* q_off,
                        const void* k_off, const void* seg_q, const void* seg_k,
                        int b, int h, int hkv, int n, int kn, int d, int dv,
                        const long long* strides, float scale, float softcap,
                        int causal, int window, int dtype, void* stream) {
  return entry(false, q, k, v, dout, lse, delta, dq, unused, q_off, k_off, seg_q,
               seg_k, b, h, hkv, n, kn, d, dv, strides, scale, softcap, causal,
               window, dtype, stream);
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv_out, const void* q_off,
                         const void* k_off, const void* seg_q, const void* seg_k,
                         int b, int h, int hkv, int n, int kn, int d, int dv,
                         const long long* strides, float scale, float softcap,
                         int causal, int window, int dtype, void* stream) {
  return entry(true, q, k, v, dout, lse, delta, dk, dv_out, q_off, k_off, seg_q,
               seg_k, b, h, hkv, n, kn, d, dv, strides, scale, softcap, causal,
               window, dtype, stream);
}

// What the last dq or dk/dv launch that succeeded on the calling host
// thread took: 0 the CUDA-core kernels, 1 the tensor-core ones; -1 before
// any. The wrappers read it after each launch, so that their `route` says
// what ran, not what they expected.
int flash_bwd_last_launch() { return last_launch; }

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
