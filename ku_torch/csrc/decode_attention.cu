// Flash-decoding: one query token per sequence, G grouped query heads per
// KV head, online softmax over the live prefix. One fold serves two ways of
// addressing a slot: a dense cache row, or a page pool through a per-row
// block table.
//
// Replaces ku/pallas/decode_attention.py::_kernel (the dense variant of
// decode_attention, :80-221) as decode_attention_launch, and
// _paged_kernel, _paged_kernel_v3 and _paged_kernel_v4 (:224, :321, :451;
// decode_attention_paged, :644) as decode_attention_paged_launch. The three
// paged variants differ only in the TPU's DMA scheduling and are bit-exact,
// so this one kernel serves every value of their `pipelined`.
//
// Contract (ku's layout, slot axis MINOR):
//   q        (B, Hkv, G, D)    f32 or bf16
//   out      (B, Hkv, G, Dv)   q's dtype
//   dense:   k (B, Hkv, D, S), v (B, Hkv, Dv, S), scales (B, Hkv, S);
//            lengths (B,) int32 live slots per row, clamped to S
//   paged:   k (NP, Hkv, D, pg), v (NP, Hkv, Dv, pg), scales (NP, Hkv, pg),
//            table (B, MP) int32, the pool page of each logical page;
//            lengths (B,) clamped to MP * pg (a longer row reads the whole
//            window unmasked, as ku's kernel does)
//   K/V in q's dtype, or int8 with f32 per-slot scales.
// Scores: s = (q . k) [* k_scale] * softmax_scale, then cap*tanh(s/cap)
// when softcap > 0, then slots >= length masked to -1e30 (not -inf: a
// fully masked tile must not turn exp(m_prev - m_new) into NaN).
// Probabilities: p = exp(s - m) in f32, the running sum l takes p before
// the v scale, then p [* v_scale] is rounded to q's dtype before the PV
// product, whose sum is f32 -- as ku's kernels do. A row of length <= 0
// writes 0.
//
// Paged: only live pages are read. The block stages the row's first
// ceil(len / pg) table entries in shared memory (never an entry past MP,
// never a dead one, which may hold any value, even a poisoned page), then
// a slot's page is table[slot / pg] and its offset slot % pg.
//
// What bounds it on an H100: bytes. A step reads each live K/V slot once
// (B * Hkv * len * (D + Dv) elements) and does 4 * G * D flops per slot,
// far below the ~295 flops per byte the card needs before the tensor
// cores would matter. At the serving shapes (B = 8, Hkv = 4, D = 128,
// len 300..1100, bf16) that is 1 to 9 MB, a few microseconds at
// 3.35 TB/s. What limits it today is latency: only B * Hkv = 32 blocks on
// 132 SMs, each walking its slots as a chain of dependent device-memory
// loads (one tile's K, then its V, then the next tile). The paged chain
// starts with one more dependent load, the table, and is longer where a
// context spans 3-5 pages. Split-K over slots or pages, with a final
// reduce, which would put more blocks and more loads in flight, is the
// next step.
//
// Design: one block per (b, kv-head); its G query heads share every K/V
// load. The block walks the live prefix 0..len-1 only, in tiles of 128
// slots (the live-prefix clamp ku does in its index map). A thread owns
// one slot of the tile: it reads K[d][slot] for d = 0..D-1, so a warp's
// loads are consecutive slots of one d and coalesce (in the paged case
// within a page, so for pg >= 32; any pg works); it keeps G partial
// scores in registers. The tile's V slab and v scales are staged through
// shared memory the same coalesced way and read back by column, so that
// each thread owns output columns d and G f32 accumulators. One warp per
// head does the tile's max and sum with shuffles.

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

// Where slot `slot` of block (b, h) lives: in "unit" u (a (row, head) of
// the dense cache, a (page, head) of the pool) at offset `off`. Element
// (dd, slot) of K is k[(u * D + dd) * stride + off], of V
// v[(u * Dv + dd) * stride + off], its scales s[u * stride + off].
struct DenseRows {
  int s;  // slots per row
  __device__ __forceinline__ int window() const { return s; }
  __device__ __forceinline__ int stride() const { return s; }
  __device__ __forceinline__ void stage(int*, int, int, int) const {}
  __device__ __forceinline__ size_t unit_off(int bh, int, int, int slot,
                                             const int*, int* off) const {
    *off = slot;
    return bh;
  }
};

struct PagedRows {
  const int* table;  // (B, MP)
  int pg, mp;
  __device__ __forceinline__ int window() const { return pg * mp; }
  __device__ __forceinline__ int stride() const { return pg; }
  // The row's live table entries into shared memory: entries past
  // ceil(len / pg) are never read.
  __device__ __forceinline__ void stage(int* tbl_s, int b, int len, int tid) const {
    const int live_pages = (len + pg - 1) / pg;
    for (int j = tid; j < live_pages; j += kTile) tbl_s[j] = table[(size_t)b * mp + j];
  }
  __device__ __forceinline__ size_t unit_off(int, int h, int hkv, int slot,
                                             const int* tbl_s, int* off) const {
    const int j = slot / pg;
    *off = slot - j * pg;
    return (size_t)tbl_s[j] * hkv + h;
  }
};

template <typename QT, typename KT, int GMAX, typename Rows>
__global__ void __launch_bounds__(kTile)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const int* __restrict__ lengths,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, QT* __restrict__ out,
              int hkv, int g, int d, int dv, Rows rows, float scale,
              float softcap) {
  extern __shared__ float smem[];
  constexpr int kLd = kTile + 1;
  constexpr int kDvPer = kMaxDv / kTile;  // output columns a thread owns
  float* qs = smem;              // g * d
  float* ps = qs + g * d;        // g * kLd: scores, then probabilities
  float* vt = ps + g * kLd;      // dv * kLd: the tile's V slab
  float* vss = vt + dv * kLd;    // kTile: the tile's v scales
  float* m_run = vss + kTile;    // g
  float* l_run = m_run + g;      // g
  float* corr = l_run + g;       // g
  int* tbl_s = reinterpret_cast<int*>(corr + g);  // paged: the live entries

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / hkv, h = bh - b * hkv;
  const int len = min(lengths[b], rows.window());
  const int stride = rows.stride();
  const QT* qb = q + (size_t)bh * g * d;

  rows.stage(tbl_s, b, len, tid);
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
    int slot_off = 0;
    const size_t unit = live ? rows.unit_off(bh, h, hkv, slot, tbl_s, &slot_off) : 0;
    const KT* kp = k + unit * d * stride + slot_off;
    const KT* vp = v + unit * dv * stride + slot_off;
    float sc[GMAX];
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg) sc[gg] = 0.f;
    if (live) {
      for (int dd = 0; dd < d; ++dd) {
        const float kv = to_f32(kp[(size_t)dd * stride]);
#pragma unroll
        for (int gg = 0; gg < GMAX; ++gg)
          if (gg < g) sc[gg] += qs[gg * d + dd] * kv;
      }
    }
    for (int dd = 0; dd < dv; ++dd)
      vt[dd * kLd + tid] = live ? to_f32(vp[(size_t)dd * stride]) : 0.f;
    const float ks = (live && k_scale) ? k_scale[unit * stride + slot_off] : 1.f;
    if (v_scale) vss[tid] = live ? v_scale[unit * stride + slot_off] : 1.f;
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg) {
      if (gg < g) {
        float s = sc[gg];
        if (k_scale) s *= ks;
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
        const float pv = v_scale ? p * vss[c] : p;
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

// table_entries: MP for the paged kernel, 0 for the dense one.
size_t smem_bytes(int g, int d, int dv, int table_entries) {
  return sizeof(float) * ((size_t)g * d + (size_t)g * (kTile + 1) +
                          (size_t)dv * (kTile + 1) + kTile + 3 * (size_t)g) +
         sizeof(int) * (size_t)table_entries;
}

struct Args {
  const void *q, *k, *v, *lengths, *k_scale, *v_scale;
  void* out;
  int b, hkv, g, d, dv;
  float scale, softcap;
  size_t smem;
  cudaStream_t stream;
};

template <typename QT, typename KT, int GMAX, typename Rows>
cudaError_t launch(const Args& a, Rows rows) {
  auto kernel = decode_kernel<QT, KT, GMAX, Rows>;
  static size_t allowed = 48 * 1024;  // raised once per instantiation
  if (a.smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
    allowed = a.smem;
  }
  kernel<<<a.b * a.hkv, kTile, a.smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const int*>(a.lengths),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<QT*>(a.out), a.hkv, a.g, a.d, a.dv, rows, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename QT, typename KT, typename Rows>
cudaError_t by_group(const Args& a, Rows rows) {
  if (a.g <= 4) return launch<QT, KT, 4>(a, rows);
  if (a.g <= 16) return launch<QT, KT, 16>(a, rows);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 f32, 1 bf16, 2 int8 (K/V only).
template <typename Rows>
cudaError_t by_dtype(const Args& a, Rows rows, int q_dtype, int kv_dtype) {
  if (a.b < 1 || a.hkv < 1 || a.g < 1 || a.d < 1 || a.dv < 1 || a.dv > kMaxDv ||
      a.smem > 227 * 1024)
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) return by_group<float, float>(a, rows);
  if (q_dtype == 0 && kv_dtype == 2) return by_group<float, int8_t>(a, rows);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_group<__nv_bfloat16, __nv_bfloat16>(a, rows);
  if (q_dtype == 1 && kv_dtype == 2) return by_group<__nv_bfloat16, int8_t>(a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t: cudaErrorInvalidValue for shapes
// the kernel does not take (G > 16, Dv > 128, shared memory past the block
// limit), else the launch's own error.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, const void* k_scale,
                            const void* v_scale, void* out, int b, int hkv,
                            int g, int d, int dv, int s, float scale,
                            float softcap, int q_dtype, int kv_dtype,
                            void* stream) {
  if (s < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, k_scale, v_scale, out, b, hkv, g, d, dv,
               scale, softcap, smem_bytes(g, d, dv, 0),
               static_cast<cudaStream_t>(stream)};
  return by_dtype(a, DenseRows{s}, q_dtype, kv_dtype);
}

int decode_attention_paged_launch(const void* q, const void* k, const void* v,
                                  const void* table, const void* lengths,
                                  const void* k_scale, const void* v_scale,
                                  void* out, int b, int hkv, int g, int d,
                                  int dv, int pg, int mp, float scale,
                                  float softcap, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (pg < 1 || mp < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, k_scale, v_scale, out, b, hkv, g, d, dv,
               scale, softcap, smem_bytes(g, d, dv, mp),
               static_cast<cudaStream_t>(stream)};
  return by_dtype(a, PagedRows{static_cast<const int*>(table), pg, mp},
                  q_dtype, kv_dtype);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
