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
// Paged: only live pages are read. Each block stages the table entries of
// its own chunk in shared memory (never an entry past MP, never a dead one,
// which may hold any value, even a poisoned page), then a slot's page is
// table[slot / pg] and its offset slot % pg.
//
// What bounds it on an H100: bytes. A step reads each live K/V slot once
// (B * Hkv * len * (D + Dv) elements) and does 4 * G * D flops per slot,
// far below the ~295 flops per byte the card needs before the tensor
// cores' rate would matter. At the serving shapes (B = 8, Hkv = 4, D = 128,
// bf16, len 192..1,152) that is 3.7 to 15.7 MB, 1.1 to 4.7 us at
// 3.35 TB/s: so short that latency, not rate, is what the design fights:
// enough SMs, enough bytes in flight, few dependent steps.
//
// Split-K over a thread-block cluster. The grid is (B * Hkv, kSplit) with
// clusters of (1, kSplit, 1): the kSplit = 8 blocks of a cluster share one
// (row, KV head). Block r folds the slots [r c, min((r + 1) c, len)) with
// c = roundup(ceil(len / kSplit), kTile) (split_chunk): a plan that depends
// on the row's clamped length alone, never on B, S, pg, MP or the SM
// count, so a paged and a dense read of the same slots, or a row read
// alone and in a batch, fold the same chunks in the same order and agree
// bit for bit. A block whose chunk is empty reads nothing (not even a
// table entry) and publishes an empty partial (m = -1e30, l = 0, acc = 0).
// B * Hkv = 32 becomes 256 blocks; at 192..1,152 live slots 3 to 8 of a
// row's blocks hold work.
//
// Bytes in flight. A block streams its chunk through a ring of 2..4
// stages in shared memory, each a tile of kTile = 64 slots: D rows of K,
// Dv rows of V (and 64 k and v scales for int8), each (row, 64 slots) a
// contiguous run of the slot-minor cache (128 bytes in bf16, 64 in int8,
// 256 in f32). 16-byte cp.async copies fill it, every stage's copies in
// flight from the start; a paged copy resolves its page once per 16-byte
// segment (a segment never straddles a page: pg is a multiple of its
// slots), and a segment past the chunk's end reads nothing and lands as
// zeros (the copy's zero fill), so a tile holds nothing but live slots
// and zeros. The launch takes the stages (4, 3 or 2) at which its B * Hkv
// clusters run in the fewest waves, as cudaOccupancyMaxActiveClusters
// counts the clusters the card holds at once, and never launches where
// none fits: at the serving shapes (bf16, D = Dv = 128, B * Hkv = 32)
// two stages, at which three blocks share an SM and all 32 clusters run at
// once. Rows are stored with their 16-byte segments XOR-swizzled
// (swz), so that the reads below are free of bank conflicts. Shapes the
// 16-byte copies cannot take (S or pg not a multiple of the segment's
// slots, a base not 16-byte aligned) take the same kernel with element
// loads (kVec false), chosen by shape and reported by
// decode_attention_last_launch.
//
// The fold, per tile, by 256 threads (8 warps) in three barriers. Where q
// and K/V are bf16 (the serving path; G <= 4, D <= 128 and D, Dv
// multiples of 16) it runs on the tensor cores (kMma), not for their rate
// but for their latency: S^T = K^T q^T is 8 dependent mma.sync.m16n8k16 a
// warp (K^T's fragments by ldmatrix.trans straight from K's rows), and
// O^T += V P^T another 4, with f32 accumulators and the same products as
// the CUDA cores' (bf16 times bf16 is exact in f32). Elsewhere each
// thread sums a quarter of D for one slot and every query head on the
// CUDA cores in f32 (q transposed, so that one 16-byte load serves 4
// heads) and the quarters meet in shared memory. Either way warp w then
// owns heads w and w + 8 and lane l slots 2l and 2l + 1: the tile's max
// and sum and the running (m, l) stay in registers and shuffles, and the
// probabilities, rounded to q's dtype, go to shared memory for the PV
// product (on the CUDA cores thread t owns column t % 128 of heads t / 128,
// t / 128 + 2, ..., reading V 16 bytes at a time).
//
// The merge, in distributed shared memory: block r merges columns
// [r ceil(Dv / 8), ...) of every head. Each block pushes its partial (m, l
// and those columns of acc[G][Dv], f32) into the merging blocks' shared
// memory through map_shared_rank (each arrived at the cluster's barrier
// when it started, and waits for all to have arrived before it writes);
// after one cluster.sync() each block reads the eight partials from its
// own shared memory in the fixed order 0..7 and writes its columns in q's
// dtype. No workspace, no second launch, no atomics, and no block waits
// for another to finish reading.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;    // blocks of a cluster: a row's chunks
constexpr int kTile = 64;    // slots per tile; a chunk is a multiple of it
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDv = 128;  // widest value head: one output column a thread's
constexpr float kMasked = -1e30f;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may take

// Slots per chunk of a row of `len` live slots (0 for len <= 0).
__host__ __device__ inline int split_chunk(int len) {
  if (len <= 0) return 0;
  const int per = len / kSplit + (len % kSplit != 0);
  return (per + kTile - 1) / kTile * kTile;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One 16-byte segment of a V row as its 16 / sizeof(KT) values.
__device__ __forceinline__ void load_seg(const unsigned char* p, const float*, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void load_seg(const unsigned char* p, const __nv_bfloat16*,
                                         float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_seg(const unsigned char* p, const int8_t*, float* x) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  const int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xff));
}

// Byte offset of byte `b` of tile row `row` (rows of kTile * sizeof(KT)
// bytes): the row's 16-byte segments XOR-swizzled, so that eight
// consecutive rows' segment j (a quarter warp's 16-byte reads of V, one
// column a thread) fall in eight different bank groups, while a warp's
// reads along one row (the scores) still cover it once.
template <typename KT>
__device__ __forceinline__ int swz(int row, int b) {
  constexpr int kRowBytes = kTile * sizeof(KT);
  constexpr int kSegs = kRowBytes / 16;  // 16 (f32), 8 (bf16), 4 (int8)
  const int sw = kSegs >= 8 ? (row & 7) : ((row >> 1) & (kSegs - 1));
  return row * kRowBytes + ((((b >> 4) ^ sw)) << 4) + (b & 15);
}

// Waits until at most n (0..3) of this thread's committed copy groups are
// in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: attn_mma::cp_async_wait<0>(); break;
    case 1: attn_mma::cp_async_wait<1>(); break;
    case 2: attn_mma::cp_async_wait<2>(); break;
    default: attn_mma::cp_async_wait<3>(); break;
  }
}

template <typename KT>
__device__ __forceinline__ void zero_elem(unsigned char* p) {
  if constexpr (sizeof(KT) == 4) {
    *reinterpret_cast<uint32_t*>(p) = 0u;
  } else if constexpr (sizeof(KT) == 2) {
    *reinterpret_cast<uint16_t*>(p) = 0u;
  } else {
    *p = 0u;
  }
}

template <typename KT>
__device__ __forceinline__ void copy_elem(unsigned char* dst, const KT* src) {
  *reinterpret_cast<KT*>(dst) = *src;
}

// Where slot `slot` of block (b, h) lives: in "unit" u (a (row, head) of
// the dense cache, a (page, head) of the pool) at offset `off`. Element
// (dd, slot) of K is k[(u * D + dd) * stride + off], of V
// v[(u * Dv + dd) * stride + off], its scales s[u * stride + off].
struct Where {
  size_t unit;
  int off;
};

struct DenseRows {
  static constexpr bool kPaged = false;
  int s;  // slots per row
  __device__ __forceinline__ int window() const { return s; }
  __device__ __forceinline__ int stride() const { return s; }
  __device__ __forceinline__ int first_page(int) const { return 0; }
  __device__ __forceinline__ Where where(int bh, int, int, int slot, const int*, int) const {
    return {(size_t)bh, slot};
  }
};

struct PagedRows {
  static constexpr bool kPaged = true;
  const int* table;  // (B, MP)
  int pg, mp;
  __device__ __forceinline__ int window() const { return pg * mp; }
  __device__ __forceinline__ int stride() const { return pg; }
  __device__ __forceinline__ int first_page(int lo) const { return lo / pg; }
  // The table entries of the chunk [lo, hi) into shared memory, none for an
  // empty chunk: entries past ceil(len / pg) are never read.
  __device__ __forceinline__ void stage(int* tbl_s, int b, int lo, int hi, int tid) const {
    if (lo >= hi) return;
    const int j0 = lo / pg, j1 = (hi - 1) / pg;
    for (int j = j0 + tid; j <= j1; j += kThreads) tbl_s[j - j0] = table[(size_t)b * mp + j];
  }
  __device__ __forceinline__ Where where(int, int h, int hkv, int slot, const int* tbl_s,
                                         int j0) const {
    const int j = slot / pg;
    return {(size_t)tbl_s[j - j0] * hkv + h, slot - j * pg};
  }
};

// The table entries a block may stage: the pages a chunk can touch.
int table_cap(int pg, int mp) {
  const int c = split_chunk(pg * mp);
  return c / pg + 2 < mp ? c / pg + 2 : mp;
}

// One block's chunk [lo, hi) and where its tiles go. Tile t of the chunk
// goes into stage t % stages: 16-byte copies (kVec) of every segment that
// starts before hi, or element loads of every slot before hi. Nothing past
// hi is read; what a stage holds there is masked.
template <typename KT, typename Rows, bool kVec>
struct Loader {
  static constexpr int kRowBytes = kTile * sizeof(KT);
  Rows rows;
  const KT* k;
  const KT* v;
  const float* k_scale;
  const float* v_scale;
  unsigned char* smem;
  const int* tbl_s;
  size_t stage_bytes;
  int stages, d, dv, lo, hi, n_tiles, j0, stride, bh, h, hkv, tid;

  __device__ __forceinline__ void operator()(int t) const {
    if (t >= n_tiles) return;
    unsigned char* st = smem + (size_t)(t % stages) * stage_bytes;
    unsigned char* vs_st = st + (size_t)d * kRowBytes;
    float* sc_st = reinterpret_cast<float*>(st + (size_t)(d + dv) * kRowBytes);
    const int t0 = lo + t * kTile;
    if constexpr (kVec) {
      // This thread's segment, in rows r0, r0 + kStep, ...: every such row
      // has the same swizzle (kStep is a multiple of 8), so its address in
      // the stage, as in the cache, steps by a constant. Of its 16 bytes
      // those before hi are read and the rest zero-filled: a segment past
      // hi reads nothing (not even its table entry) and lands as zeros.
      constexpr int kSlotsPerSeg = 16 / sizeof(KT);
      constexpr int kSegs = kTile / kSlotsPerSeg;
      constexpr int kStep = kThreads / kSegs;
      const int seg = tid % kSegs, slot = t0 + seg * kSlotsPerSeg, r0 = tid / kSegs;
      const int bytes = min(max(hi - slot, 0) * (int)sizeof(KT), 16);
      const KT* kp = k;
      const KT* vp = v;
      size_t step = 0;
      if (bytes > 0) {
        const Where w = rows.where(bh, h, hkv, slot, tbl_s, j0);
        kp += (w.unit * d + r0) * stride + w.off;
        vp += (w.unit * dv + r0) * stride + w.off;
        step = (size_t)kStep * stride;
      }
      const int sw = swz<KT>(r0, seg * 16);
      for (int row = r0; row < d; row += kStep, kp += step)
        attn_mma::cp_async16(st + sw + (row - r0) * kRowBytes, kp, bytes);
      for (int row = r0; row < dv; row += kStep, vp += step)
        attn_mma::cp_async16(vs_st + sw + (row - r0) * kRowBytes, vp, bytes);
      if (k_scale && tid < 2 * (kTile / 4)) {  // 16 segments of 4 scales each, k then v
        const int which = tid / (kTile / 4), s4 = tid % (kTile / 4), s0 = t0 + 4 * s4;
        const int sbytes = min(max(hi - s0, 0) * 4, 16);
        const float* src = which ? v_scale : k_scale;
        if (sbytes > 0) {
          const Where w = rows.where(bh, h, hkv, s0, tbl_s, j0);
          src += w.unit * stride + w.off;
        }
        attn_mma::cp_async16(sc_st + which * kTile + 4 * s4, src, sbytes);
      }
    } else {
      // Element loads of the slots before hi; zeros past it.
      const int sl = tid % kTile, slot = t0 + sl;
      const int b_off = sl * (int)sizeof(KT);
      const int which = tid / kTile;  // threads 0..63 k scales, 64..127 v
      if (slot < hi) {
        const Where w = rows.where(bh, h, hkv, slot, tbl_s, j0);
        const KT* kp = k + w.unit * d * stride + w.off;
        const KT* vp = v + w.unit * dv * stride + w.off;
        for (int row = tid / kTile; row < d; row += kThreads / kTile)
          copy_elem(st + swz<KT>(row, b_off), kp + (size_t)row * stride);
        for (int row = tid / kTile; row < dv; row += kThreads / kTile)
          copy_elem(vs_st + swz<KT>(row, b_off), vp + (size_t)row * stride);
        if (k_scale && which < 2)
          sc_st[which * kTile + sl] = (which ? v_scale : k_scale)[w.unit * stride + w.off];
      } else {
        for (int row = tid / kTile; row < d; row += kThreads / kTile)
          zero_elem<KT>(st + swz<KT>(row, b_off));
        for (int row = tid / kTile; row < dv; row += kThreads / kTile)
          zero_elem<KT>(vs_st + swz<KT>(row, b_off));
        if (k_scale && which < 2) sc_st[which * kTile + sl] = 0.f;
      }
    }
  }
};

// A scalar of a K row in shared memory.
__device__ __forceinline__ float load_one(const unsigned char* p, const float*) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float load_one(const unsigned char* p, const __nv_bfloat16*) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
__device__ __forceinline__ float load_one(const unsigned char* p, const int8_t*) {
  return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// rows of matrix i (trans: each delivered transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(attn_mma::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(attn_mma::smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory past the ring, in floats: the probabilities ps (g, kTile),
// the score quarters red (4, g, kTile), q transposed (d, gq), the
// corrections (g), the inbox of partials (kSplit, g, ceil(dv / kSplit)) and
// their (m, l) (kSplit, g, 2); then the table entries (ints).
__host__ __device__ inline size_t tail_floats(int g, int d, int dv) {
  const int gq = (g + 3) & ~3;
  const size_t q_floats = (size_t)d * gq > (size_t)g * (d + 8) / 2 + 1 ? (size_t)d * gq
                                                                     : (size_t)g * (d + 8) / 2 + 1;
  return (size_t)g * kTile + 4 * (size_t)g * kTile + q_floats + g +
         (size_t)kSplit * g * ((dv + kSplit - 1) / kSplit) + 2 * (size_t)kSplit * g;
}

// Blocks an SM the register budget must allow: three where a block's ring
// is small enough for three to share an SM (bf16 or int8 K/V, G <= 4), two
// for G up to 16, one for f32 K/V (two stages of f32 tiles take an SM's
// shared memory).
template <typename KT, int GMAX>
constexpr int min_blocks() {
  return sizeof(KT) == 4 ? 1 : (GMAX <= 4 ? 3 : 2);
}

template <typename QT, typename KT, int GMAX, typename Rows, bool kVec, bool kMma>
__global__ void __launch_bounds__(kThreads, (min_blocks<KT, GMAX>()))
decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ lengths,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    QT* __restrict__ out, int hkv, int g, int d, int dv, Rows rows,
                    float scale, float softcap, int stages) {
  constexpr int kRowBytes = kTile * sizeof(KT);
  constexpr int kSlotsPerSeg = 16 / sizeof(KT);  // 4, 8, 16
  constexpr int kHpw = (GMAX + kWarps - 1) / kWarps;  // heads a warp's softmax owns
  constexpr int kHpt = (GMAX + 1) / 2;                // heads a thread's PV owns
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const bool quant = k_scale != nullptr;
  const size_t stage_bytes =
      (size_t)(d + dv) * kRowBytes + (quant ? 2 * kTile * sizeof(float) : 0);
  const int gq = (g + 3) & ~3;  // a row of q transposed: whole float4s
  float* ps = reinterpret_cast<float*>(smem + stages * stage_bytes);  // g * kTile
  float* red = ps + g * kTile;     // 4 * g * kTile: the score quarters
  float* qt = red + 4 * g * kTile;  // d * gq: q transposed
  float* corr_s = qt + max(d * gq, g * (d + 8) / 2 + 1);  // g
  // The partials of this block's columns, pushed by every block of the
  // cluster: acc (kSplit, g, ceil(dv / kSplit)), then (m, l) (kSplit, g).
  float* inbox = corr_s + g;
  float* inbox_ml = inbox + kSplit * g * ((dv + kSplit - 1) / kSplit);
  int* tbl_s = reinterpret_cast<int*>(inbox_ml + 2 * kSplit * g);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x, b = bh / hkv, h = bh - b * hkv;
  const int len = max(0, min(lengths[b], rows.window()));
  const int c = split_chunk(len);
  const int lo = min(r * c, len), hi = min(lo + c, len);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const int j0 = rows.first_page(lo);
  const int stride = rows.stride();
  const QT* qb = q + (size_t)bh * g * d;
  // This block has started: the others may write its inbox once all have
  // (the wait before the push).
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  // The table entries first (the copies' addresses need them), then the
  // first tiles' copies, then q, whose loads overlap the copies; the first
  // tile's barrier makes q visible. A block with an empty chunk reads
  // neither.
  if constexpr (Rows::kPaged) {
    rows.stage(tbl_s, b, lo, hi, tid);
    __syncthreads();
  }
  const Loader<KT, Rows, kVec> issue{rows, k, v, k_scale, v_scale, smem, tbl_s, stage_bytes,
                                      stages, d, dv, lo, hi, n_tiles, j0, stride, bh, h, hkv,
                                      tid};
  for (int t = 0; t < stages; ++t) {
    issue(t);
    attn_mma::cp_async_commit();
  }
  // The CUDA cores read q transposed (qt, f32); the tensor cores (kMma:
  // bf16, G <= 4, D <= 128 a multiple of 16) read it as bf16 rows of
  // D + 8 (the 16 bytes more put the heads' rows on other banks), the B
  // operand of S^T = K^T q^T.
  const int dq16 = d + 8;
  if (n_tiles > 0) {
    if constexpr (kMma) {
      QT* q16 = reinterpret_cast<QT*>(qt);
      for (int i = tid; i < g * d; i += kThreads) q16[i / d * dq16 + i % d] = qb[i];
    } else {
      for (int i = tid; i < g * d; i += kThreads) qt[i % d * gq + i / d] = to_f32(qb[i]);
    }
  }

  // The scores: warp w sums rows of D in quarter w % 4 (8-row groups
  // gi = w % 4, w % 4 + 4, ..., then tail rows) for slot 32 (w / 4) + lane
  // and every head, two chains (even and odd rows) a head; the quarters
  // meet in red. The softmax: warp w owns heads w, w + 8, lane l slots 2l
  // and 2l + 1. The PV product: thread t owns column t % 128 and heads
  // t / 128, t / 128 + 2, ...
  const int quarter = warp & 3, slot = 32 * (warp >> 2) + lane;
  const int b_one = slot * (int)sizeof(KT);
  const int s_a = 2 * lane;
  const int col = tid & 127, hg = tid >> 7;
  // PV's accumulators: on the CUDA cores heads 2 e + hg of column col; on
  // the tensor cores the fragment of O^T (dv 16 warp + lane / 4 (+ 8),
  // heads 2 (lane % 4) + {0, 1}).
  constexpr int kAcc = kMma ? 4 : kHpt;
  float m_run[kHpw], l_run[kHpw], acc[kAcc];
#pragma unroll
  for (int i = 0; i < kHpw; ++i) m_run[i] = kMasked, l_run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed (this thread's copies: tile T is copy group T, so
    // `stages` groups are committed before tile 0 and one more before each
    // later tile), and every thread is done with tile t - 1, whose stage
    // then takes tile t - 1 + stages.
    cp_async_wait_upto(t == 0 ? stages - 1 : stages - 2);
    __syncthreads();
    if (t > 0) {
      issue(t - 1 + stages);
      attn_mma::cp_async_commit();
    }

    const unsigned char* st = smem + (size_t)(t % stages) * stage_bytes;
    const unsigned char* vs_st = st + (size_t)d * kRowBytes;
    const float* ks_st = reinterpret_cast<const float*>(st + (size_t)(d + dv) * kRowBytes);
    const float* vss_st = ks_st + kTile;
    const int n_live = min(kTile, hi - lo - t * kTile);

    // The score parts that red holds: one from the tensor cores, the four
    // quarters of D from the CUDA cores.
    constexpr int kParts = kMma ? 1 : 4;
    if constexpr (kMma) {
      // S^T (64 slots x 8 heads) = K^T (slots x D) q^T: warp w < 4 its 16
      // slots, D / 16 steps; K^T's fragments come transposed from K's rows.
      if (warp < 4) {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        const int i = lane >> 3, rr = lane & 7, head = lane >> 2;
        // q's fragment: head lane / 4 (zero past G), rows 16 ks + 2 (lane % 4)
        // + {0, 1} and those + 8.
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const QT*>(qt) + head * dq16 + 2 * (lane & 3));
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (16 * ks < d) {
            uint32_t a4[4];
            ldsm_x4_trans(a4, st + swz<KT>(16 * ks + rr + 8 * (i >> 1),
                                           16 * (2 * warp + (i & 1))));
            const uint32_t b0 = head < g ? qw[8 * ks] : 0u, b1 = head < g ? qw[8 * ks + 4] : 0u;
            mma_16816(c4, a4, b0, b1);
          }
        }
        const int m = 16 * warp + (lane >> 2), n = 2 * (lane & 3);
        if (n < g) red[n * kTile + m] = c4[0], red[n * kTile + m + 8] = c4[2];
        if (n + 1 < g) red[(n + 1) * kTile + m] = c4[1], red[(n + 1) * kTile + m + 8] = c4[3];
      }
    } else {
    // Two chains a head (even and odd rows of a group) where the heads are
    // few; the heads are the chains where they are many. A row's swizzle
    // depends on the row modulo 8 alone (swz).
    constexpr int kChains = GMAX <= 4 ? 2 : 1;
    float sc[GMAX][kChains];
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg)
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) sc[gg][ch] = 0.f;
    const int n_groups = d >> 3;
    for (int gi = quarter; gi < n_groups; gi += 4) {
      const unsigned char* kr = st + gi * 8 * kRowBytes;
      float kx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kx[j] = load_one(kr + swz<KT>(j, b_one), k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* qrow = qt + (gi * 8 + j) * gq;
#pragma unroll
        for (int h4 = 0; h4 < GMAX; h4 += 4) {
          if (h4 < g) {
            const float4 q4 = *reinterpret_cast<const float4*>(qrow + h4);
            sc[h4][j % kChains] += q4.x * kx[j];
            sc[h4 + 1][j % kChains] += q4.y * kx[j];
            sc[h4 + 2][j % kChains] += q4.z * kx[j];
            sc[h4 + 3][j % kChains] += q4.w * kx[j];
          }
        }
      }
    }
    for (int dd = (n_groups << 3) + quarter; dd < d; dd += 4) {
      const float kx = load_one(st + swz<KT>(dd, b_one), k);
      const float* qrow = qt + dd * gq;
#pragma unroll
      for (int gg = 0; gg < GMAX; ++gg)
        if (gg < g) sc[gg][0] += qrow[gg] * kx;
    }
#pragma unroll
    for (int gg = 0; gg < GMAX; ++gg) {
      if (gg < g) {
        float x = sc[gg][0];
#pragma unroll
        for (int ch = 1; ch < kChains; ++ch) x += sc[gg][ch];
        red[(quarter * g + gg) * kTile + slot] = x;
      }
    }
    }
    __syncthreads();

#pragma unroll
    for (int hh = 0; hh < kHpw; ++hh) {
      const int gg = warp + kWarps * hh;
      if (gg >= g) continue;
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int qq = 0; qq < kParts; ++qq) {
        const float2 part = *reinterpret_cast<const float2*>(red + (qq * g + gg) * kTile + s_a);
        s[0] += part.x;
        s[1] += part.y;
      }
      bool live[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[j];
        if (quant) x *= ks_st[s_a + j];
        x *= scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        live[j] = s_a + j < n_live;
        s[j] = live[j] ? x : kMasked;
      }
      float mt = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run[hh], mt);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float cr = expf(m_run[hh] - m_new);
      l_run[hh] = l_run[hh] * cr + sum;
      m_run[hh] = m_new;
      float pv0 = live[0] ? p0 : 0.f, pv1 = live[1] ? p1 : 0.f;
      if (quant) {
        pv0 = live[0] ? p0 * vss_st[s_a] : 0.f;
        pv1 = live[1] ? p1 * vss_st[s_a + 1] : 0.f;
      }
      *reinterpret_cast<float2*>(ps + gg * kTile + s_a) =
          make_float2(round_as(pv0, qb), round_as(pv1, qb));
      if (lane == 0) corr_s[gg] = cr;
    }
    __syncthreads();

    if constexpr (kMma) {
      // O^T (Dv x 8 heads) += V (Dv x 64 slots) P^T: warp w its 16 rows of
      // V, four steps of 16 slots; P^T's fragments are the probabilities,
      // already rounded to bf16, of heads lane / 4.
      if (16 * warp < dv) {
        const int n = 2 * (lane & 3), head = lane >> 2;
        const float c_lo = n < g ? corr_s[n] : 0.f, c_hi = n + 1 < g ? corr_s[n + 1] : 0.f;
        acc[0] *= c_lo, acc[1] *= c_hi, acc[2] *= c_lo, acc[3] *= c_hi;
        const int i = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks) {
          uint32_t a4[4];
          ldsm_x4(a4, vs_st + swz<KT>(16 * warp + rr + 8 * (i & 1), 16 * (2 * ks + (i >> 1))));
          uint32_t b0 = 0u, b1 = 0u;
          if (head < g) {
            const float* pr = ps + head * kTile + 16 * ks + n;
            b0 = attn_mma::pack_bf16(pr[0], pr[1]);
            b1 = attn_mma::pack_bf16(pr[8], pr[9]);
          }
          mma_16816(acc, a4, b0, b1);
        }
      }
    } else if (col < dv) {
#pragma unroll
      for (int e = 0; e < kHpt; ++e)
        if (2 * e + hg < g) acc[e] *= corr_s[2 * e + hg];
      // Segments past the live slots are skipped: their p is 0, as is
      // every value past the last live slot (the loader's zero fill).
      const int n_seg = (n_live + kSlotsPerSeg - 1) / kSlotsPerSeg;
      for (int seg = 0; seg < n_seg; ++seg) {
        float vv[kSlotsPerSeg];
        load_seg(vs_st + swz<KT>(col, seg * 16), k, vv);
#pragma unroll
        for (int e = 0; e < kHpt; ++e) {
          const int gg = 2 * e + hg;
          if (gg < g) {
            const float* pr = ps + gg * kTile + seg * kSlotsPerSeg;
            float a = acc[e];
#pragma unroll
            for (int i = 0; i < kSlotsPerSeg; i += 4) {
              const float4 p4 = *reinterpret_cast<const float4*>(pr + i);
              a += p4.x * vv[i];
              a += p4.y * vv[i + 1];
              a += p4.z * vv[i + 2];
              a += p4.w * vv[i + 3];
            }
            acc[e] = a;
          }
        }
      }
    }
  }
  attn_mma::cp_async_wait<0>();  // no copy may land after the block's exit

  // Push this block's partial to the blocks that merge it: its columns
  // [rr per, (rr + 1) per) to block rr's inbox, its (m, l) to every
  // block's. The cluster's blocks have all started by now (each arrived at
  // the barrier first thing), so their shared memory may be written.
  const int per = (dv + kSplit - 1) / kSplit;
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if constexpr (kMma) {
    if (16 * warp < dv) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c_ = 16 * warp + (lane >> 2) + 8 * (e >> 1), n = 2 * (lane & 3) + (e & 1);
        if (n < g) {
          const int rr = c_ / per;
          cluster.map_shared_rank(inbox, rr)[(r * g + n) * per + c_ - rr * per] = acc[e];
        }
      }
    }
  } else if (col < dv) {
    const int rr = col / per, cc = col - rr * per;
    float* box = cluster.map_shared_rank(inbox, rr);
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      if (2 * e + hg < g) box[(r * g + 2 * e + hg) * per + cc] = acc[e];
  }
#pragma unroll
  for (int hh = 0; hh < kHpw; ++hh) {
    const int gg = warp + kWarps * hh;
    if (gg < g && lane < kSplit) {
      float* ml = cluster.map_shared_rank(inbox_ml, lane);
      ml[2 * (r * g + gg)] = m_run[hh];
      ml[2 * (r * g + gg) + 1] = l_run[hh];
    }
  }
  cluster.sync();

  // Merge this block's columns of every head from its own inbox, over the
  // partials in order 0..7: M = max m_r, w_r = exp(m_r - M),
  // L = sum l_r w_r, o = sum acc_r w_r. Nothing reads another block's
  // shared memory after the barrier, so no block waits for the others to
  // finish.
  const int c0 = r * per, n_col = max(0, min(per, dv - c0));
  QT* ob = out + (size_t)bh * g * dv;
  for (int i = tid; i < g * n_col; i += kThreads) {
    const int gg = i / n_col, cc = i % n_col;
    float M = kMasked;
#pragma unroll
    for (int rr = 0; rr < kSplit; ++rr) M = fmaxf(M, inbox_ml[2 * (rr * g + gg)]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int rr = 0; rr < kSplit; ++rr) {
      const float w = expf(inbox_ml[2 * (rr * g + gg)] - M);
      L += inbox_ml[2 * (rr * g + gg) + 1] * w;
      o += inbox[(rr * g + gg) * per + cc] * w;
    }
    store(ob + gg * dv + c0 + cc, o / fmaxf(L, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *lengths, *k_scale, *v_scale;
  void* out;
  int b, hkv, g, d, dv;
  float scale, softcap;
  int tbl_cap;
  cudaStream_t stream;
};

// What the last launch took: the route (1: 16-byte copies, 0: element
// loads), its stages, the blocks of a cluster (kSplit) and how many of its
// clusters the card holds at once.
int g_last_launch = -1;

size_t smem_bytes(const Args& a, int kv_size, int stages) {
  const size_t stage = (size_t)(a.d + a.dv) * kTile * kv_size +
                       (a.k_scale ? 2 * kTile * sizeof(float) : 0);
  return stages * stage + sizeof(float) * tail_floats(a.g, a.d, a.dv) +
         sizeof(int) * (size_t)a.tbl_cap;
}

template <typename QT, typename KT, int GMAX, typename Rows, bool kVec, bool kMma>
cudaError_t launch(const Args& a, Rows rows) {
  auto kernel = decode_split_kernel<QT, KT, GMAX, Rows, kVec, kMma>;
  // The shared memory sizes of this instantiation known to raise no
  // error and to fit a cluster, with the clusters the card holds at once
  // at each, and the most allowed so far.
  static size_t fits[8] = {0};
  static int fit_clusters[8] = {0};
  static int n_fits = 0;
  int clusters = 0;
  static size_t allowed = 48 * 1024;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kSplit;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(a.b * a.hkv, kSplit, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // The stages (4, 3 or 2) at which the B * Hkv clusters run in the
  // fewest waves, as cudaOccupancyMaxActiveClusters counts the clusters
  // the card holds at once; the most stages among those. No launch if no
  // cluster fits.
  int stages = 0;
  long waves = 0;
  for (int n = 4; n >= 2; --n) {
    const size_t smem = smem_bytes(a, sizeof(KT), n);
    if (smem > kMaxSmem) continue;
    cfg.dynamicSmemBytes = smem;
    int held = -1;
    for (int i = 0; i < n_fits; ++i)
      if (fits[i] == smem) held = fit_clusters[i];
    if (held < 0) {
      if (smem > allowed) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        allowed = smem;
      }
      cudaError_t err = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
      if (err != cudaSuccess) return err;
      fits[n_fits % 8] = smem;
      fit_clusters[n_fits % 8] = held;
      n_fits = n_fits < 8 ? n_fits + 1 : 8;
    }
    if (held < 1) continue;
    const long w = ((long)a.b * a.hkv + held - 1) / held;
    if (stages == 0 || w < waves) stages = n, waves = w, clusters = held;
  }
  if (stages == 0) return cudaErrorInvalidConfiguration;
  cfg.dynamicSmemBytes = smem_bytes(a, sizeof(KT), stages);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const int*>(a.lengths),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<QT*>(a.out), a.hkv, a.g, a.d, a.dv, rows, a.scale, a.softcap, stages);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess)
    g_last_launch =
        (kVec ? 1 : 0) | (stages << 1) | (kSplit << 4) | (kMma ? 256 : 0) | (clusters << 9);
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte copies where every segment of the slot axis is 16 bytes whole
// and aligned: `stride` (S or pg) a multiple of the segment's slots, and
// every base 16-byte aligned; element loads otherwise.
template <typename QT, typename KT, int GMAX, typename Rows, bool kMma>
cudaError_t by_route(const Args& a, Rows rows, int stride) {
  const bool vec = stride % (16 / (int)sizeof(KT)) == 0 && aligned16(a.k) &&
                   aligned16(a.v) &&
                   (!a.k_scale || (aligned16(a.k_scale) && aligned16(a.v_scale)));
  return vec ? launch<QT, KT, GMAX, Rows, true, kMma>(a, rows)
             : launch<QT, KT, GMAX, Rows, false, kMma>(a, rows);
}

// The fold on the tensor cores where q and K/V are bf16, G <= 4, D <= 128
// and D, Dv multiples of 16 (q 4-byte aligned); on the CUDA cores
// otherwise.
template <typename QT, typename KT, typename Rows>
cudaError_t by_group(const Args& a, Rows rows, int stride) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                std::is_same<KT, __nv_bfloat16>::value) {
    if (a.g <= 4 && a.d % 16 == 0 && a.d <= 128 && a.dv % 16 == 0 &&
        reinterpret_cast<uintptr_t>(a.q) % 4 == 0)
      return by_route<QT, KT, 4, Rows, true>(a, rows, stride);
  }
  if (a.g <= 4) return by_route<QT, KT, 4, Rows, false>(a, rows, stride);
  if (a.g <= 16) return by_route<QT, KT, 16, Rows, false>(a, rows, stride);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 f32, 1 bf16, 2 int8 (K/V only).
template <typename Rows>
cudaError_t by_dtype(const Args& a, Rows rows, int stride, int q_dtype, int kv_dtype) {
  if (a.b < 1 || a.hkv < 1 || a.g < 1 || a.d < 1 || a.dv < 1 || a.dv > kMaxDv)
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) return by_group<float, float>(a, rows, stride);
  if (q_dtype == 0 && kv_dtype == 2) return by_group<float, int8_t>(a, rows, stride);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_group<__nv_bfloat16, __nv_bfloat16>(a, rows, stride);
  if (q_dtype == 1 && kv_dtype == 2)
    return by_group<__nv_bfloat16, int8_t>(a, rows, stride);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t: cudaErrorInvalidValue for shapes
// the kernel does not take (G > 16, Dv > 128), cudaErrorInvalidConfiguration
// where no cluster fits at two stages, else the launch's own error.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, const void* k_scale,
                            const void* v_scale, void* out, int b, int hkv,
                            int g, int d, int dv, int s, float scale,
                            float softcap, int q_dtype, int kv_dtype,
                            void* stream) {
  if (s < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, k_scale, v_scale, out, b, hkv, g, d, dv,
               scale, softcap, 0, static_cast<cudaStream_t>(stream)};
  return by_dtype(a, DenseRows{s}, s, q_dtype, kv_dtype);
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
               scale, softcap, table_cap(pg, mp), static_cast<cudaStream_t>(stream)};
  return by_dtype(a, PagedRows{static_cast<const int*>(table), pg, mp}, pg, q_dtype,
                  kv_dtype);
}

// What the last successful launch of either entry took, -1 before the
// first: bit 0 the route (1 16-byte copies, 0 element loads), bits 1-3 the
// stages of its ring, bits 4-7 the blocks of a cluster (a row's chunks),
// bit 8 the fold (1 tensor cores, 0 CUDA cores), bits 9 and up the
// clusters of its shape the card holds at once
// (cudaOccupancyMaxActiveClusters).
int decode_attention_last_launch() { return g_last_launch; }

// The slots of each chunk of a row of `length` live slots, as the kernel
// plans it (the blocks of a cluster fold consecutive chunks).
int decode_attention_split_chunk(int length) { return split_chunk(length); }

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
