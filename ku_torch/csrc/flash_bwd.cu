// Flash-attention backward: dq, and dk / dv, recomputed tile by tile from
// the forward's saved f32 log-sum-exp.
//
// Replaces ku/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (through _bwd_pallas, :503-890).
//
// Contract (the forward's, flash_fwd.cu):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv), dout (B, H, N, Dv):
//     f32 or bf16, any strides; query head j reads KV head j / (H / Hkv).
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
// at 3.35 TB/s: operations bound both. These kernels do their products in
// f32 on the CUDA cores (no tensor cores yet), so in practice the f32 FMA
// and shared-memory rate bounds them, far above either.
//
// Design, in the forward's style: 256 threads a block, 64 x 64 tiles held
// in shared memory as f32, the TPU's sequential grid axis a loop inside the
// block over the live tiles only (the forward's rule from the row offsets).
// - dq: one block per (batch * head, 64-query tile). The Q and dout tiles
//   stay in shared memory; each live K and V tile is staged in turn. Thread
//   t owns query row t / 4 and keys t % 4 + 4 j of the tile: it computes
//   their 16 scores and 16 dp values in registers, writes ds to a shared
//   tile, and accumulates D / 4 columns of its dq row in f32 registers.
// - dk / dv: one block per (batch * KV head, 64-key tile). The K and V
//   tiles stay in shared memory; the block walks the live query tiles of
//   EVERY query head of the group, staging Q, dout, lse and delta. Thread t
//   owns key row t / 4 and queries t % 4 + 4 j: it writes p and ds to two
//   shared tiles and accumulates D / 4 columns of dk and Dv / 4 of dv in
//   f32 registers. Summing the group inside the block replaces ku's
//   per-query-head partials and their f32 sum (:882-890): no atomics, the
//   same order every run, one rounding at the end.
// Rows are padded to D + 1 and 65 words so that the 8 rows a warp reads lie
// on distinct banks. Shared memory at D = Dv = 128: dq 149 KB, dk / dv
// 166 KB, above the 48 KB a block gets without cudaFuncSetAttribute.
// mma.sync / wgmma on bf16, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

size_t dq_smem_bytes(int d, int dv) {
  return sizeof(float) * (2 * (size_t)kBq * (d + 1) + 2 * (size_t)kBk * (dv + 1) +
                          (size_t)kBq * (kBk + 1) + kBk);
}

size_t dkv_smem_bytes(int d, int dv) {
  return sizeof(float) * (2 * (size_t)kBk * (d + 1) + 2 * (size_t)kBq * (dv + 1) +
                          2 * (size_t)kBk * (kBq + 1) + 3 * kBq);
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
cudaError_t launch_dq(const Args& a, int b, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  return launch(flash_bwd_dq_kernel<T, DMAX>, dq_smem_bytes(a.d, a.dv), &allowed,
                dim3((a.n + kBq - 1) / kBq, b * a.h), a, stream);
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a, int b, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  return launch(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem_bytes(a.d, a.dv), &allowed,
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

int entry(bool dkv, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* out0,
          void* out1, const void* q_off, const void* k_off, const void* seg_q,
          const void* seg_k, int b, int h, int hkv, int n, int kn, int d,
          int dv, const long long* st, float scale, float softcap,
          int causal, int window, int dtype, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv || n < 1 || kn < 1 || d < 1 ||
      d > kMaxD || dv < 1 || dv > kMaxD || (dkv ? b * hkv : b * h) > 65535 ||
      (dkv ? dkv_smem_bytes(d, dv) : dq_smem_bytes(d, dv)) > 227 * 1024 ||
      (dkv && !out1))
    return cudaErrorInvalidValue;
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
  if (dtype == 0) return by_width<float>(dkv, a, b, s);
  if (dtype == 1) return by_width<__nv_bfloat16>(dkv, a, b, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 f32, 1 bf16. strides: 16 element strides, (batch, head,
// seq, dim) for each of q, k, v, dout. window <= 0: none; softcap <= 0:
// none. out1 is unused by the dq entry. Each returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernels do not take (D or Dv > 128,
// H not a multiple of Hkv, a grid past 65,535 rows).
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

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
