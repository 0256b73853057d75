// Flash-decoding over a dense KV cache: one query token per sequence,
// G grouped query heads per KV head, online softmax over the live prefix.
//
// Replaces ku/pallas/decode_attention.py::_kernel (the dense variant of
// decode_attention, :80-221).
//
// Contract (ku's layout, slot axis MINOR):
//   q        (B, Hkv, G, D)    f32 or bf16
//   k        (B, Hkv, D, S)    q's dtype, or int8 with k_scale
//   v        (B, Hkv, Dv, S)   q's dtype, or int8 with v_scale
//   lengths  (B,) int32        live slots per row (index + 1), clamped to S
//   k_scale, v_scale (B, Hkv, S) f32 per-slot scales (int8 caches only)
//   out      (B, Hkv, G, Dv)   q's dtype
// Scores: s = (q . k) [* k_scale] * softmax_scale, then cap*tanh(s/cap)
// when softcap > 0, then slots >= length masked to -1e30 (not -inf: a
// fully masked tile must not turn exp(m_prev - m_new) into NaN).
// Probabilities: p = exp(s - m) in f32, the running sum l takes p before
// the v scale, then p [* v_scale] is rounded to q's dtype before the PV
// product, whose sum is f32 -- as ku's kernel does. A row of length <= 0
// writes 0.
//
// What bounds it on an H100: bytes. A step reads each live K/V slot once
// (B * Hkv * len * (D + Dv) elements) and does 4 * G * D flops per slot,
// far below the ~295 flops per byte the card needs before the tensor
// cores would matter. At the serving shapes (B = 8, Hkv = 4, D = 128,
// len <= 400, bf16) that is a few MB, about a microsecond at 3.35 TB/s,
// so one launch is dominated by its latency and by having only B * Hkv
// blocks in flight.
//
// Design: one block per (b, kv-head); its G query heads share every K/V
// load. The block walks the live prefix 0..len-1 only, in tiles of 128
// slots (the live-prefix clamp ku does in its index map). A thread owns
// one slot of the tile: it reads K[d][slot] for d = 0..D-1, so a warp's
// loads are consecutive slots of one d and coalesce; it keeps G partial
// scores in registers. The tile's V slab is staged through shared memory
// the same coalesced way and read back by column, so that each thread
// owns output columns d and G f32 accumulators. One warp per head does
// the tile's max and sum with shuffles. Split-K over slots, which would
// put more than B * Hkv blocks on the card, is a later optimisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // slots per tile = threads per block
constexpr int kMaxDv = 128;  // widest value head instantiated
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename QT, typename KT, int GMAX>
__global__ void __launch_bounds__(kTile)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const int* __restrict__ lengths,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, QT* __restrict__ out,
              int hkv, int g, int d, int dv, int s_total, float scale,
              float softcap) {
  extern __shared__ float smem[];
  constexpr int kLd = kTile + 1;
  constexpr int kDvPer = kMaxDv / kTile;  // output columns a thread owns
  float* qs = smem;              // g * d
  float* ps = qs + g * d;        // g * kLd: scores, then probabilities
  float* vt = ps + g * kLd;      // dv * kLd: the tile's V slab
  float* m_run = vt + dv * kLd;  // g
  float* l_run = m_run + g;      // g
  float* corr = l_run + g;       // g

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / hkv;
  const int len = min(lengths[b], s_total);
  const QT* qb = q + (size_t)bh * g * d;
  const KT* kb = k + (size_t)bh * d * s_total;
  const KT* vb = v + (size_t)bh * dv * s_total;
  const float* ksb = k_scale ? k_scale + (size_t)bh * s_total : nullptr;
  const float* vsb = v_scale ? v_scale + (size_t)bh * s_total : nullptr;

  for (int i = tid; i < g * d; i += kTile) qs[i] = to_f32(qb[i]);
  if (tid < g) {
    m_run[tid] = kMasked;
    l_run[tid] = 0.f;
  }
  float acc[GMAX][kDvPer];
#pragma unroll
  for (int gg = 0; gg < GMAX; ++gg)
#pragma unroll
    for (int j = 0; j < kDvPer; ++j) acc[gg][j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int slot = t0 + tid;
    const bool live = slot < len;
    float sc[GMAX];
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg) sc[gg] = 0.f;
    if (live) {
      for (int dd = 0; dd < d; ++dd) {
        const float kv = to_f32(kb[(size_t)dd * s_total + slot]);
#pragma unroll
        for (int gg = 0; gg < GMAX; ++gg)
          if (gg < g) sc[gg] += qs[gg * d + dd] * kv;
      }
    }
    for (int dd = 0; dd < dv; ++dd)
      vt[dd * kLd + tid] = live ? to_f32(vb[(size_t)dd * s_total + slot]) : 0.f;
    const float ks = (live && ksb) ? ksb[slot] : 1.f;
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg) {
      if (gg < g) {
        float s = sc[gg];
        if (ksb) s *= ks;
        s *= scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ps[gg * kLd + tid] = live ? s : kMasked;
      }
    }
    __syncthreads();

    // Online softmax, one warp per head: each lane holds 4 of the 128.
    for (int gg = warp; gg < g; gg += kTile / 32) {
      float x[kTile / 32];
      float mt = kMasked;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        x[i] = ps[gg * kLd + lane + 32 * i];
        mt = fmaxf(mt, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_run[gg];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const float p = expf(x[i] - m_new);
        sum += p;
        const int c = lane + 32 * i;
        const float pv = (vsb && t0 + c < len) ? p * vsb[t0 + c] : p;
        ps[gg * kLd + c] = round_as(pv, qb);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        corr[gg] = cr;
        l_run[gg] = l_run[gg] * cr + sum;
        m_run[gg] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kDvPer; ++j) {
      const int col = tid + kTile * j;
      if (col < dv) {
#pragma unroll
        for (int gg = 0; gg < GMAX; ++gg) {
          if (gg < g) {
            float a = acc[gg][j] * corr[gg];
            const float* pr = ps + gg * kLd;
            const float* vr = vt + col * kLd;
#pragma unroll 8
            for (int c = 0; c < kTile; ++c) a += pr[c] * vr[c];
            acc[gg][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  QT* ob = out + (size_t)bh * g * dv;
#pragma unroll
  for (int j = 0; j < kDvPer; ++j) {
    const int col = tid + kTile * j;
    if (col < dv) {
#pragma unroll
      for (int gg = 0; gg < GMAX; ++gg)
        if (gg < g) store(ob + gg * dv + col, acc[gg][j] / fmaxf(l_run[gg], 1e-30f));
    }
  }
}

size_t smem_bytes(int g, int d, int dv) {
  return sizeof(float) * ((size_t)g * d + (size_t)g * (kTile + 1) +
                          (size_t)dv * (kTile + 1) + 3 * (size_t)g);
}

template <typename QT, typename KT, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, const void* k_scale,
                   const void* v_scale, void* out, int b, int hkv, int g,
                   int d, int dv, int s, float scale, float softcap,
                   cudaStream_t stream) {
  auto kernel = decode_kernel<QT, KT, GMAX>;
  const size_t bytes = smem_bytes(g, d, dv);
  static size_t allowed = 48 * 1024;  // raised once per instantiation
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  kernel<<<b * hkv, kTile, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), hkv, g, d, dv, s, scale, softcap);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_group(const void* q, const void* k, const void* v,
                     const void* lengths, const void* k_scale,
                     const void* v_scale, void* out, int b, int hkv, int g,
                     int d, int dv, int s, float scale, float softcap,
                     cudaStream_t stream) {
#define KU_DECODE_LAUNCH(GM)                                                \
  return launch<QT, KT, GM>(q, k, v, lengths, k_scale, v_scale, out, b, hkv, \
                            g, d, dv, s, scale, softcap, stream)
  if (g <= 4) KU_DECODE_LAUNCH(4);
  if (g <= 16) KU_DECODE_LAUNCH(16);
#undef KU_DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 f32, 1 bf16, 2 int8 (K/V only). Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernel does not take (G > 16,
// Dv > 128, shared memory past the block limit).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, const void* k_scale,
                            const void* v_scale, void* out, int b, int hkv,
                            int g, int d, int dv, int s, float scale,
                            float softcap, int q_dtype, int kv_dtype,
                            void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || d < 1 || dv < 1 || dv > kMaxDv || s < 1 ||
      smem_bytes(g, d, dv) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_group<float, float>(q, k, v, lengths, k_scale, v_scale, out, b,
                                  hkv, g, d, dv, s, scale, softcap, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return by_group<float, int8_t>(q, k, v, lengths, k_scale, v_scale, out, b,
                                   hkv, g, d, dv, s, scale, softcap, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_group<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, k_scale, v_scale, out, b, hkv, g, d, dv, s, scale,
        softcap, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return by_group<__nv_bfloat16, int8_t>(q, k, v, lengths, k_scale, v_scale,
                                           out, b, hkv, g, d, dv, s, scale,
                                           softcap, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
