// Flash-attention forward: streaming online-softmax attention that also
// emits the f32 log-sum-exp of every query row.
//
// Replaces ku/pallas/flash_attention.py::_fwd_kernel (through _fwd_pallas,
// :154-495).
//
// Contract (ku's layout):
//   q (B, H, N, D), k (B, Hkv, KN, D), v (B, Hkv, KN, Dv): f32 or bf16;
//     query head j reads KV head j / (H / Hkv) (GQA). Strides: any on the
//     f32 route; on the tensor-core route (a) rows unit-stride along D, or
//     (b) k and v unit-stride along the keys (the slot-minor KV cache that
//     the serving prefill hands in as a transposed view, read in place), in
//     16-byte runs (see the entry); the wrapper copies anything else.
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
// What bounds it on an H100: 4 * D operations a live pair (S and PV) at the
// 989 TFLOP/s bf16 tensor-core peak, or the bytes (Q, O, lse and the live
// K/V once) at 3.35 TB/s, whichever is longer. At the training shape (B 8,
// H 16 over 4, N = KN = 1,024, D 128, causal) that is 34 GFLOP, 0.035 ms:
// operations. At the serving prefill (B 8, H 16, N 128 over a 1,024-slot
// cache at offset 0, D 128) about 0.2 GFLOP against about 4 MB: bytes.
//
// Two routes, chosen at the C entry; nothing falls back from one to the
// other.
// - bf16 with D, Dv <= 128: the tensor-core kernel (flash_fwd_wgmma_kernel,
//   over attn_mma.cuh). One warpgroup (128 threads) per (batch * head,
//   64-query tile), two blocks an SM. S = Q K^T is a wgmma with both
//   operands in shared memory, O += P V a wgmma with P in registers (the
//   score fragments rounded to bf16 by pack_a: FlashAttention-2's scheme);
//   bf16 in, f32 sums, the scores never leave the accumulator fragments.
//   Tiles sit in wgmma's 128-byte swizzled layout, filled by 16-byte
//   cp.async copies that zero-fill rows past N or KN and columns past D or
//   Dv, so any D, Dv <= 128 and any N, KN work and nothing outside a tile is
//   read. K and V are double-buffered: the next tile is copied during this
//   one's products. Layout (a): a K or V tile is 64 keys x D, K-major for
//   S and read transposed (MN-major) for PV. Layout (b): the tile is D rows
//   x 64 keys straight from the cache, MN-major for S and K-major for PV
//   (attn_mma.cuh's TRANS_B forms): the cache needs no copy. The key loop
//   visits only the tiles the causal edge and the window leave live,
//   computed from the row's offsets (ku's _live_fwd); a tile whose corners
//   pass every clause tests no pair, any other builds a bitmask of its
//   live pairs once. Under a causal mask query tile i walks i + 1 key
//   tiles, so the grid starts the last query tiles first. Shared memory:
//   Q and two stages of K and V, 5 * 64 * DMAX bf16 + 1 KB of alignment,
//   81 KB at DMAX 128 (two blocks an SM in 227 KB). Its time at the
//   training shape and its registers are in PERF.md.
// - f32, and bf16 with D > 128: the CUDA-core kernel (flash_fwd_kernel),
//   kept from before the tensor cores for f32 because TF32 would miss the
//   f32 comparisons at 1e-4. One block of 256 threads per (batch * head,
//   64-query tile) walks the same live key tiles; Q, K and V are staged
//   through shared memory in f32 along whichever axis is unit-stride, so
//   any strides work. Thread t owns query row t / 4 and keys t % 4 + 4 j of
//   the tile: its 16 scores stay in registers, the row's max and sum take
//   two shuffles among the 4 threads of the row, the probabilities go
//   through a shared tile to the same 4 threads, and each thread
//   accumulates Dv / 4 output columns of its row in f32 registers. Rows
//   padded to 65 (and D to D + 1) words keep the 8 rows a warp reads on
//   distinct banks. Shared memory is 4 * (64 * (2 D + Dv + 3) + 64 * 65)
//   bytes, about 116 KB at D = 128. The f32 FMA and shared-memory rate
//   bound it, at about 150x the operation bound (PERF.md).
// Both ask for their shared memory through cudaFuncSetAttribute; a launch
// past it is refused and only cudaGetLastError says so.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

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


// ---------------------------------------------------------------------------
// bf16 with D, Dv <= 128: the tensor-core kernel (see the head of the file).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
using attn_mma::bf16;

struct MmaArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  const int *q_off, *k_off, *seg_q, *seg_k;
  int h, hkv, n, kn, d, dv;
  Strides sq, sk, sv;
  float scale, softcap;
  int causal, window;
};

// KV_T: layout (b), k and v unit-stride along the keys (the slot-minor
// cache); else layout (a), rows unit-stride along D.
template <int DMAX, bool KV_T>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_fwd_wgmma_kernel(MmaArgs a) {
  using namespace attn_mma;
  constexpr int kTile = kBq * DMAX, kNt = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = swizzle_base(smem_raw);  // kBq x DMAX
  bf16* ks = qs + kTile;              // 2 stages: kBk x DMAX, or DMAX x kBk (KV_T)
  bf16* vs = ks + 2 * kTile;          // 2 stages, the same

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  // The (batch * head) is the grid's fast axis and the query tiles run from
  // the last: under a causal mask the last tiles walk the most keys.
  const int bh = blockIdx.x, b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.hkv);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int q_end = min(q_start + kBq, a.n);
  const int row0 = q_start + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const DenseMask mask{a.n, a.kn, a.q_off[b], a.k_off[b], a.causal, a.window,
                       a.seg_q ? a.seg_q + (long long)b * a.n : nullptr,
                       a.seg_k ? a.seg_k + (long long)b * a.kn : nullptr};
  const bf16* qp = a.q + b * a.sq.b + hq * a.sq.h;
  const bf16* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = a.v + b * a.sv.b + hk * a.sv.h;
  int kt_lo, kt_hi;
  mask.key_tiles(q_start, q_end - 1, kt_lo, kt_hi);

  // Key tile `tile` of K and V into stage st: 64 keys x D (zero past KN and
  // D), or in layout (b) D rows x 64 keys of the cache (zero past D and KN).
  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kBk;
    if constexpr (KV_T) {
      load_tile_sw128<DMAX, kBk, kMmaThreads>(ks + st * kTile, kp + k0, a.sk.d, 0, a.d,
                                              a.kn - k0);
      load_tile_sw128<DMAX, kBk, kMmaThreads>(vs + st * kTile, vp + k0, a.sv.d, 0, a.dv,
                                              a.kn - k0);
    } else {
      load_tile_sw128<kBk, DMAX, kMmaThreads>(ks + st * kTile, kp, a.sk.n, k0, a.kn, a.d);
      load_tile_sw128<kBk, DMAX, kMmaThreads>(vs + st * kTile, vp, a.sv.n, k0, a.kn, a.dv);
    }
  };

  float o[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  if (kt_lo < kt_hi) {
    load_tile_sw128<kBq, DMAX, kMmaThreads>(qs, qp, a.sq.n, q_start, a.n, a.d);
    load_kv(kt_lo, 0);
  }
  cp_async_commit();
  for (int tile = kt_lo, stage = 0; tile < kt_hi; ++tile, stage ^= 1) {
    if (tile + 1 < kt_hi) load_kv(tile + 1, stage ^ 1);  // copied during these products
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bf16* kt = ks + stage * kTile;
    const bf16* vt = vs + stage * kTile;
    const int k_start = tile * kBk;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if constexpr (KV_T)
        wgmma_ss_n64<1>(s, desc_k<kBq>(qs, 0, kk), desc_mn<DMAX>(kt, kk * 16));
      else
        wgmma_ss_n64(s, desc_k<kBq>(qs, 0, kk), desc_k<kBk>(kt, 0, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<8>(s);

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
    float mt[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        const float x = capped(s[j][e] * a.scale, a.softcap, dcap);
        s[j][e] = live >> (4 * j + e) & 1u ? x : kMasked;
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
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (KV_T)
        wgmma_rs<DMAX, 0>(o, pa[kk], desc_k<DMAX>(vt, 0, kk));
      else
        wgmma_rs<DMAX>(o, pa[kk], desc_mn<kBk>(vt, kk * 16));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags<kNt>(o);
    fence_frags<4>(pa);
    __syncthreads();  // this stage is read; the next iteration refills it
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
    bf16* orow = a.o + row * a.dv;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      store_pair(orow, j * 8 + 2 * t, a.dv, none ? 0.f : o[j][2 * r] / l,
                 none ? 0.f : o[j][2 * r + 1] / l);
    if (t == 0) a.lse[row] = none ? kMasked : m_run[r] + logf(l);
  }
}

// Q and two stages of K and V, DMAX wide, and 1 KB to align them.
size_t mma_smem_bytes(int dmax) { return 5 * sizeof(bf16) * kBq * dmax + 1024; }

template <int DMAX, bool KV_T>
cudaError_t launch_mma(const MmaArgs& a, int b, cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<DMAX, KV_T>;
  const size_t bytes = mma_smem_bytes(DMAX);
  static size_t allowed = 48 * 1024;  // raised once per instantiation
  if (bytes > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  kernel<<<dim3(b * a.h, (a.n + kBq - 1) / kBq), kMmaThreads, bytes, stream>>>(a);
  return cudaGetLastError();
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

// What the last launch that succeeded on this host thread took
// (flash_fwd_last_launch): 0 the CUDA cores, 1 the tensor cores reading
// rows (layout a), 2 the tensor cores reading k and v along the keys
// (layout b); -1 before any.
thread_local int last_launch = -1;

cudaError_t took(cudaError_t err, int how) {
  if (err == cudaSuccess) last_launch = how;
  return err;
}

}  // namespace

extern "C" {

// dtype codes: 0 f32, 1 bf16. Strides in elements, (batch, head, seq, dim)
// for each of q, k, v. window <= 0: none; softcap <= 0: none. bf16 with D
// and Dv <= 128 takes the tensor-core kernel, in layout (a) when q, k and v
// are all runs_aligned (attn_mma.cuh) along D, in layout (b) when q is and
// k and v are along the keys (so a cache whose slots are 16-byte multiples, read from
// key tiles that start at multiples of 64), and is refused with
// cudaErrorMisalignedAddress otherwise (the wrapper copies such tensors
// first). f32, and bf16 with D > 128, take the CUDA-core kernel with any
// strides. Returns a cudaError_t: cudaErrorInvalidValue for shapes the
// kernels do not take (Dv > 128, shared memory past the block limit, H not
// a multiple of Hkv, more than 65,535 rows of the grid's slow axis: query
// tiles on the tensor cores, B * H on the CUDA cores).
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
      dv < 1 || dv > kMaxDv)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_h, sq_n, sq_d}, sk{sk_b, sk_h, sk_n, sk_d},
      sv{sv_b, sv_h, sv_n, sv_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d <= kMaxDv) {  // the tensor cores
    if ((n + kBq - 1) / kBq > 65535) return cudaErrorInvalidValue;
    using attn_mma::runs_aligned;
    const long long qs[4] = {sq_b, sq_h, sq_n, sq_d}, ks[4] = {sk_b, sk_h, sk_n, sk_d},
                    vs[4] = {sv_b, sv_h, sv_n, sv_d};
    if (!runs_aligned(q, qs, b, h, n, d, 3)) return cudaErrorMisalignedAddress;
    bool kv_t;
    if (runs_aligned(k, ks, b, hkv, kn, d, 3) && runs_aligned(v, vs, b, hkv, kn, dv, 3))
      kv_t = false;
    else if (runs_aligned(k, ks, b, hkv, kn, d, 2) && runs_aligned(v, vs, b, hkv, kn, dv, 2))
      kv_t = true;
    else
      return cudaErrorMisalignedAddress;
    const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o),
                    static_cast<float*>(lse), static_cast<const int*>(q_off),
                    static_cast<const int*>(k_off), static_cast<const int*>(seg_q),
                    static_cast<const int*>(seg_k), h, hkv, n, kn, d, dv, sq, sk, sv,
                    scale, softcap, causal, window};
    const cudaError_t err =
        max(d, dv) <= 64
            ? (kv_t ? launch_mma<64, true>(a, b, st) : launch_mma<64, false>(a, b, st))
            : (kv_t ? launch_mma<128, true>(a, b, st) : launch_mma<128, false>(a, b, st));
    return took(err, kv_t ? 2 : 1);
  }
  if (smem_bytes(d, dv) > 227 * 1024 || b * h > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return took(by_width<float>(q, k, v, o, lse, q_off, k_off, seg_q, seg_k, b, h,
                                hkv, n, kn, d, dv, sq, sk, sv, scale, softcap,
                                causal, window, st),
                0);
  if (dtype == 1)
    return took(by_width<__nv_bfloat16>(q, k, v, o, lse, q_off, k_off, seg_q, seg_k,
                                        b, h, hkv, n, kn, d, dv, sq, sk, sv, scale,
                                        softcap, causal, window, st),
                0);
  return cudaErrorInvalidValue;
}

// What the last launch that succeeded on the calling host thread took: 0
// the CUDA-core kernel, 1 the tensor-core kernel reading rows (layout a), 2
// the tensor-core kernel reading k and v along the keys (layout b); -1
// before any. The wrapper reads it after each launch, so that its `route`
// and `layout` say what ran, not what it expected.
int flash_fwd_last_launch() { return last_launch; }

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
