// Flash-attention forward: streaming online-softmax attention that also
// emits the f32 log-sum-exp of every query row.
//
// Replaces ku/pallas/flash_attention.py::_fwd_kernel (through _fwd_pallas,
// :154-495).
//
// Contract (ku's layout):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv): f32 or bf16, any
//     strides (the serving prefill hands in the slot-minor KV cache as a
//     transposed view, so no copy is made); query head j reads KV head
//     j / (H / Hkv) (GQA).
//   q_off, k_off (B,) int32: global positions of query 0 and key 0 per row.
//   seg_q (B, N), seg_k (B, KN) int32 or null: packed-sequence ids.
//   o (B, H, N, Dv) in q's dtype, lse (B, H, N) f32, both contiguous.
// Scores: s = (q . k) * scale; cap*tanh(s/cap) when softcap > 0, before the
// masks; then -1e30 where a key is past KN, in another segment, in the
// causal future (k_off + key > q_off + query) or out of the window
// (q_off + query - (k_off + key) >= window). -1e30 and not -inf: a tile
// whose keys are all masked must not turn exp(m_prev - m_new) into NaN.
// p = exp(s - m) in f32, rounded to v's dtype before the PV product, whose
// sum is f32; o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). A
// row with no live key at all writes o = 0 and lse = -1e30.
//
// What bounds it on an H100: at the serving prefill (B = 8, H = 16,
// N = 128, live keys <= 192 of a 1,024-slot cache, D = 128, bf16) the
// operations are 4 * B * H * (live pairs) * D, about 0.2 GFLOP, 0.2 us at
// the 989 TFLOP/s bf16 tensor-core peak, and the bytes (Q, O and the live
// K/V once) about 4 MB, 1.2 us at 3.35 TB/s: bytes bound it. This kernel
// does its products in f32 on the CUDA cores (no tensor cores yet), so in
// practice the f32 FMA and shared-memory rate bound it, far above either.
//
// Design: one block of 256 threads per (batch * head, 64-query tile); the
// key loop runs inside the block (the TPU's sequential third grid axis
// becomes a loop) and visits only the 64-key tiles that the causal edge and
// the window leave live, computed from the row's offsets (ku's _live_fwd).
// The Q tile stays in shared memory in f32; each K and V tile is staged
// through shared memory, loaded along whichever axis is unit-stride so the
// loads coalesce. Thread t owns query row t / 4 and keys t % 4 + 4 j of the
// tile: its 16 scores stay in registers, the row's max and sum take two
// shuffles among the 4 threads of the row, the probabilities go through a
// shared tile to the same 4 threads, and each thread accumulates Dv / 4
// output columns of its row in f32 registers. Rows padded to 65 (and D to
// D + 1) words keep the 8 rows a warp reads on distinct banks. Shared
// memory is 4 * (64 * (2 D + Dv + 3) + 64 * 65) bytes, about 116 KB at
// D = 128, which a block gets only after cudaFuncSetAttribute; the launch
// is refused without it and only cudaGetLastError says so. mma.sync, TMA
// and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64, kBk = 64, kThreads = 256;
constexpr int kCols = kBk / 4;  // keys of a tile one thread scores
constexpr int kMaxDv = 128;     // widest value head instantiated
constexpr float kMasked = -1e30f;

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

// Stage rows [row0, row0 + rows) x [0, cols) of a strided (n, cols) slab
// into dst (leading dimension ld) as f32, zero past n; the loop runs along
// the unit-stride axis so consecutive threads read consecutive addresses.
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_off,
                 const int* __restrict__ k_off, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, int h, int hkv, int n, int kn,
                 int d, int dv, Strides sq, Strides sk, Strides sv,
                 float scale, float softcap, int causal, int window) {
  extern __shared__ float smem[];
  const int ldq = d + 1, ldv = dv + 1, ldp = kBk + 1;
  float* qs = smem;               // kBq x ldq
  float* ks = qs + kBq * ldq;     // kBk x ldq
  float* vs = ks + kBk * ldq;     // kBk x ldv
  float* ps = vs + kBk * ldv;     // kBq x ldp
  int* segk = reinterpret_cast<int*>(ps + kBq * ldp);  // kBk

  const int tid = threadIdx.x, r = tid >> 2, c0 = tid & 3;
  const int bh = blockIdx.y, b = bh / h, hq = bh % h;
  const int hk = hq / (h / hkv);
  const int q_start = blockIdx.x * kBq;
  const int q_last = min(q_start + kBq, n) - 1;
  const int qo = q_off[b], ko = k_off[b];
  const int qi = q_start + r;
  const bool row_valid = qi < n;
  const int my_seg = (seg_q && row_valid) ? seg_q[(long long)b * n + qi] : 0;

  const T* qb = q + b * sq.b + hq * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  // Live key tiles: at or below the causal edge of the tile's last query,
  // at or above the window's lower edge of its first.
  int kb_lo = 0, kb_hi = (kn + kBk - 1) / kBk;
  if (causal) {
    const int kmax = qo + q_last - ko;
    kb_hi = kmax < 0 ? 0 : min(kb_hi, kmax / kBk + 1);
  }
  if (window > 0) kb_lo = max(0, floor_div(qo + q_start - (window - 1) - ko, kBk));

  stage(qs, ldq, qb, sq.n, sq.d, q_start, kBq, n, d);

  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;
  float m_run = kMasked, l_run = 0.f;

  for (int t = kb_lo; t < kb_hi; ++t) {
    const int k_start = t * kBk;
    __syncthreads();  // the previous tile is done with ks, vs, ps
    stage(ks, ldq, kb, sk.n, sk.d, k_start, kBk, kn, d);
    stage(vs, ldv, vb, sv.n, sv.d, k_start, kBk, kn, dv);
    if (seg_k && tid < kBk)
      segk[tid] = k_start + tid < kn ? seg_k[(long long)b * kn + k_start + tid] : -1;
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    const float* qrow = qs + r * ldq;
    for (int dd = 0; dd < d; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] += qv * ks[(c0 + 4 * j) * ldq + dd];
    }
    float mt = kMasked;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + 4 * j, key = k_start + c;
      float x = s[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool keep = key < kn;
      if (seg_k) keep = keep && segk[c] == my_seg;
      if (causal) keep = keep && ko + key <= qo + qi;
      if (window > 0) keep = keep && (qo + qi) - (ko + key) < window;
      s[j] = keep ? x : kMasked;
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
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) acc[j] *= corr;
    const float* prow = ps + r * ldp;
    for (int c = 0; c < kBk; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * ldv;
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) {
        const int col = c0 + 4 * j;
        if (col < dv) acc[j] += p * vrow[col];
      }
    }
  }

  if (row_valid) {
    // m_run is still the masked value only when no key of the row was live
    // (masked keys of a visited tile then sum into l and acc): write 0.
    const bool none = m_run == kMasked;
    const float l = fmaxf(l_run, 1e-30f);
    T* orow = o + ((long long)bh * n + qi) * dv;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c0 + 4 * j;
      if (col < dv) store(orow + col, none ? 0.f : acc[j] / l);
    }
    if (c0 == 0) lse[(long long)bh * n + qi] = none ? kMasked : m_run + logf(l);
  }
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kBq * (d + 1) + (size_t)kBk * (d + 1) +
                          (size_t)kBk * (dv + 1) + (size_t)kBq * (kBk + 1) +
                          kBk);
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* q_off, const void* k_off,
                   const void* seg_q, const void* seg_k, int b, int h,
                   int hkv, int n, int kn, int d, int dv, Strides sq,
                   Strides sk, Strides sv, float scale, float softcap,
                   int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t bytes = smem_bytes(d, dv);
  static size_t allowed = 48 * 1024;  // raised once per instantiation
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  dim3 grid((n + kBq - 1) / kBq, b * h);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(q_off), static_cast<const int*>(k_off),
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), h, hkv,
      n, kn, d, dv, sq, sk, sv, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* q_off, const void* k_off,
                     const void* seg_q, const void* seg_k, int b, int h,
                     int hkv, int n, int kn, int d, int dv, Strides sq,
                     Strides sk, Strides sv, float scale, float softcap,
                     int causal, int window, cudaStream_t stream) {
#define KU_FLASH_LAUNCH(DM)                                                  \
  return launch<T, DM>(q, k, v, o, lse, q_off, k_off, seg_q, seg_k, b, h, hkv, \
                       n, kn, d, dv, sq, sk, sv, scale, softcap, causal,       \
                       window, stream)
  if (dv <= 32) KU_FLASH_LAUNCH(32);
  if (dv <= 64) KU_FLASH_LAUNCH(64);
  if (dv <= 128) KU_FLASH_LAUNCH(128);
#undef KU_FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 f32, 1 bf16. Strides in elements, (batch, head, seq, dim)
// for each of q, k, v. window <= 0: none; softcap <= 0: none. Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take
// (Dv > 128, shared memory past the block limit, H not a multiple of Hkv).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* q_off, const void* k_off,
                     const void* seg_q, const void* seg_k, int b, int h,
                     int hkv, int n, int kn, int d, int dv,
                     long long sq_b, long long sq_h, long long sq_n,
                     long long sq_d, long long sk_b, long long sk_h,
                     long long sk_n, long long sk_d, long long sv_b,
                     long long sv_h, long long sv_n, long long sv_d,
                     float scale, float softcap, int causal, int window,
                     int dtype, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv || n < 1 || kn < 1 || d < 1 ||
      dv < 1 || dv > kMaxDv || smem_bytes(d, dv) > 227 * 1024 ||
      b * h > 65535)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_h, sq_n, sq_d}, sk{sk_b, sk_h, sk_n, sk_d},
      sv{sv_b, sv_h, sv_n, sv_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_width<float>(q, k, v, o, lse, q_off, k_off, seg_q, seg_k, b, h,
                           hkv, n, kn, d, dv, sq, sk, sv, scale, softcap,
                           causal, window, st);
  if (dtype == 1)
    return by_width<__nv_bfloat16>(q, k, v, o, lse, q_off, k_off, seg_q, seg_k,
                                   b, h, hkv, n, kn, d, dv, sq, sk, sv, scale,
                                   softcap, causal, window, st);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
