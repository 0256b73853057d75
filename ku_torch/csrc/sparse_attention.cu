// Block-sparse flash attention: the forward (with the f32 log-sum-exp), dq,
// and dk / dv, each walking the live entries of a host-built flat block map.
//
// Replaces ku/pallas/sparse_attention.py::_sparse_fwd_kernel,
// ::_sparse_dq_kernel and ::_sparse_dkv_kernel (through _sparse_fwd and
// _sparse_bwd, :230-569).
//
// Contract (ku's layout):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv), dout (B, H, N, Dv):
//     f32 or bf16, any strides; query head j reads KV head j / (H / Hkv).
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
// three. These kernels do their products in f32 on the CUDA cores (no
// tensor cores yet), so in practice the f32 FMA and shared-memory rate
// bound them, far above either.
//
// Design: flash_fwd.cu's and flash_bwd.cu's 256-thread blocks and 64 x 64
// f32 tiles in shared memory, with the TPU's sequential map axis a loop
// inside the block over its run of the map. A TPU block of 512 rows in f32
// is 256 KB at D = 128, past an SM's 227 KB, so a CUDA block takes a 64-row
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
// Thread t owns row t / 4 and columns t % 4 + 4 j of a tile, as in the
// flash kernels; rows are padded to D + 1 and 65 words so that the 8 rows a
// warp reads lie on distinct banks. Shared memory at D = Dv = 128: forward
// 116 KB, dq 149 KB, dk / dv 166 KB, above the 48 KB a block gets without
// cudaFuncSetAttribute. mma.sync / wgmma on bf16, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64, kThreads = 256;  // sub-tile rows, of queries and keys
constexpr int kCols = kT / 4;           // pairs of a tile row one thread computes
constexpr int kMaxD = 128;              // widest head instantiated (D and Dv)
constexpr float kMasked = -1e30f;
// ku's map columns and flags.
constexpr int kQI = 0, kKB = 1, kFlag = 2, kWidth = 5;
constexpr int kFull = 0, kCausalOnly = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

enum Which { kFwd, kDq, kDkv };

size_t smem_bytes(Which w, int d, int dv) {
  const size_t qd = (size_t)kT * (d + 1), vd = (size_t)kT * (dv + 1),
               pt = (size_t)kT * (kT + 1);
  if (w == kFwd) return sizeof(float) * (2 * qd + vd + pt);
  if (w == kDq) return sizeof(float) * (2 * qd + 2 * vd + pt);
  return sizeof(float) * (2 * qd + 2 * vd + 2 * pt + 2 * kT);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t bytes, size_t* allowed, dim3 grid,
                   const Args& a, cudaStream_t stream) {
  if (bytes > *allowed) {  // raised once per instantiation
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    *allowed = bytes;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_as(Which w, const Args& a, int b, cudaStream_t stream) {
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t bytes = smem_bytes(w, a.d, a.dv);
  if (w == kDkv) {
    // Key tiles on the slow axis, so that the blocks of a key tile, one per
    // (batch, KV head), start together and the heavy ones first: a key
    // tile that many query blocks attend (the sinks; under a causal mask
    // the first) holds several times the average work, and started last it
    // would run on alone after the rest of the grid is done.
    const int tiles = (a.block_k + kT - 1) / kT;
    return launch(sparse_dkv_kernel<T, DMAX>, bytes, &allowed[w],
                  dim3(b * a.hkv, (a.kn / a.block_k) * tiles), a, stream);
  }
  const dim3 grid((a.n / a.block_q) * ((a.block_q + kT - 1) / kT), b * a.h);
  if (w == kDq) return launch(sparse_dq_kernel<T, DMAX>, bytes, &allowed[w], grid, a, stream);
  return launch(sparse_fwd_kernel<T, DMAX>, bytes, &allowed[w], grid, a, stream);
}

template <typename T>
cudaError_t by_width(Which w, const Args& a, int b, cudaStream_t stream) {
  const int widest = w == kFwd ? a.dv : max(a.d, a.dv);
  if (widest <= 32) return launch_as<T, 32>(w, a, b, stream);
  if (widest <= 64) return launch_as<T, 64>(w, a, b, stream);
  if (widest <= 128) return launch_as<T, 128>(w, a, b, stream);
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
      smem_bytes(w, d, dv) > 227 * 1024)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               out0, out1,
               static_cast<const int*>(map), static_cast<const int*>(ptr),
               h, hkv, n, kn, d, dv, block_q, block_k,
               Strides{st[0], st[1], st[2], st[3]}, Strides{st[4], st[5], st[6], st[7]},
               Strides{st[8], st[9], st[10], st[11]}, Strides{st[12], st[13], st[14], st[15]},
               scale, causal, has_window, window, global_prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(w, a, b, s);
  if (dtype == 1) return by_width<__nv_bfloat16>(w, a, b, s);
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
// sub-tiles for dk / dv).
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
