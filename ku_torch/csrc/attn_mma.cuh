// Tile routines for attention kernels on the H100's tensor cores (sm_90a):
// bf16 tiles in shared memory, filled by 16-byte cp.async copies, multiplied
// by warpgroup wgmma instructions (bf16 in, f32 accumulators), the tiles
// read by the tensor cores through shared-memory descriptors.
//
// A warpgroup (4 warps) multiplies 64 rows of A at a time; warp w of the
// group holds rows 16 w .. 16 w + 15 of the accumulator, as N / 8 fragments
// of 16 x 8 (lane = 4 g + t): float c[4], c[0], c[1] at row g, columns 2t
// and 2t + 1; c[2], c[3] at row g + 8, the same columns (mma.m16n8's layout,
// PTX ISA "Register fragment" of wgmma). An A operand in registers, one k16
// step, is uint32_t a[4] of bf16 pairs (the lower column in the low half):
// a[0] row g, columns 2t..2t+1; a[1] row g + 8; a[2] row g, columns
// 2t+8..2t+9; a[3] row g + 8, those columns. So two accumulators side by
// side (columns 16 kk .. 16 kk + 15 of S) are, rounded and packed, the A
// operand of the next product (P V, dS K) with no trip through shared
// memory: FlashAttention-2's scheme (pack_a below).
//
// Shared by the block-sparse kernels (sparse_attention.cu) and the dense
// flash kernels (flash_fwd.cu, flash_bwd.cu); the latter also take the
// dense masks at the end of this file.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory: the first src_bytes (0..16) read,
// the rest zero-filled (src_bytes 0 reads nothing). dst and src 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, the same way (src_bytes 0 or 4).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a 16 x 16 step from the accumulators of columns
// 16 kk .. 16 kk + 7 (lo) and 16 kk + 8 .. 16 kk + 15 (hi), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Two adjacent values of an output row, columns col and col + 1 (col even),
// written as far as `width`: one 4-byte store where both fit and the row
// keeps bf16 pairs aligned (width even), else one at a time.
__device__ __forceinline__ void store_pair(bf16* row, int col, int width, float x, float y) {
  if (col + 1 < width && width % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < width) row[col] = __float2bfloat16(x);
    if (col + 1 < width) row[col + 1] = __float2bfloat16(y);
  }
}

// The dynamic shared memory's first 1024-byte boundary (the launch asks for
// 1 KB more): swizzled tiles start on one.
__device__ __forceinline__ bf16* swizzle_base(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// Whether the kernels can copy a (B, heads, rows, width) tensor at p with
// element strides s[4] 16 bytes at a time along axis `unit` (3: rows
// unit-stride along the width; 2: runs along the rows, as the slot-minor
// KV cache's keys): stride 1 there, every other axis longer than 1 a
// stride of a multiple of 8 elements, and a 16-byte-aligned start. Host
// code: the C entries check their tensors with it.
inline bool runs_aligned(const void* p, const long long* s, int b, int heads, int rows,
                         int width, int unit) {
  const int dims[4] = {b, heads, rows, width};
  if (reinterpret_cast<uintptr_t>(p) % 16 || s[unit] != 1) return false;
  for (int i = 0; i < 4; ++i)
    if (i != unit && dims[i] > 1 && s[i] % 8) return false;
  return true;
}

// ---------------------------------------------------------------------------
// Tiles are stored in wgmma's 128-byte swizzled layout (load_tile_sw128):
// blocks of 64 columns, each ROWS rows of 128 bytes, 16-byte chunk c of row
// r at chunk c ^ (r % 8), every block 1024-byte aligned, so that the tensor
// cores read them without bank conflicts. One such tile serves as a K-major
// operand (rows = M or N, columns = K: S = Q K^T) and, read transposed, as
// an MN-major one (rows = K, columns = N: O += P V).
// ---------------------------------------------------------------------------

// Rows [row0, row0 + ROWS) x columns [0, COLS) of a bf16 slab (unit stride
// along a row, rows sn elements apart, src and every row 16-byte aligned)
// into a swizzled tile (COLS a multiple of 64) by 16-byte cp.async copies,
// all THREADS threads of the block taking part: rows from `end` on and
// columns from `width` on are zero-filled, never read. Each thread copies
// one chunk of every (THREADS / (COLS / 8))-th row, so its addresses are
// worked out once. The caller commits the group.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile_sw128(bf16* dst, const bf16* src, long long sn,
                                                int row0, int end, int width) {
  constexpr int kChunks = COLS / 8, kStep = THREADS / kChunks;
  static_assert(COLS % 64 == 0 && THREADS % kChunks == 0 && ROWS % kStep == 0 &&
                    kStep % 8 == 0,
                "tile shape");
  const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks, c = ch * 8;
  const int col_bytes = max(0, min(16, 2 * (width - c)));
  const bf16* from = src + (row0 + r) * sn + c;
  // r % 8, and so the swizzle, is the same for every row this thread copies.
  bf16* to = dst + (ch / 8) * ROWS * 64 + r * 64 + ((ch % 8) ^ (r % 8)) * 8;
#pragma unroll
  for (int j = 0; j < ROWS / kStep; ++j) {
    const int bytes = row0 + r + j * kStep < end ? col_bytes : 0;
    cp_async16(to + j * kStep * 64, bytes ? from + j * kStep * sn : src, bytes);
  }
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}

// A K-major operand: rows row0 .. (a multiple of 8) of a ROWS-row swizzled
// tile, columns 16 kk .. 16 kk + 15 (k16 step kk); 8-row groups 1024 bytes
// apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0, int kk) {
  return desc_sw128(tile + (kk / 4) * ROWS * 64 + row0 * 64 + (kk % 4) * 16, 16, 1024);
}

// An MN-major operand, read transposed: rows k0 .. k0 + 15 of a ROWS-row
// swizzled tile (the K of one step), all its columns (N); 64-column blocks
// ROWS * 128 bytes apart, 8-row groups 1024.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int k0) {
  return desc_sw128(tile + k0 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes (cp.async included, once
// waited for) before the tensor cores' reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins registers that a wgmma writes or reads asynchronously: no read of an
// accumulator moves above the wait, and no A register is reused before it.
template <int NT>
__device__ __forceinline__ void fence_frags(float d[][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t a[][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// d (64 x 32, f32) += A . B^T, one k16 step: A and B K-major in shared
// memory (desc_k).
__device__ __forceinline__ void wgmma_ss_n32(float d[][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A . B^T, one k16 step: A K-major in shared memory
// (desc_k); B K-major (desc_k, TRANS_B 0) or MN-major, stored with the
// step's K along its rows and its 64 N columns unit-stride (desc_mn,
// TRANS_B 1: the slot-minor cache's keys).
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_n64(float d[][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
}

// d (64 x 64, f32) += A . B, one k16 step: A in registers (each warp's 16
// rows, pack_a), B MN-major in shared memory (desc_mn, read transposed:
// TRANS_B 1) or K-major, its N rows unit-stride along the step's K
// (desc_k, TRANS_B 0: the slot-minor cache's values).
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_n64(float d[][4], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
}

// d (64 x 128, f32) += A . B, one k16 step: as wgmma_rs_n64.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs_n128(float d[][4], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
}

// wgmma_rs_n64 or _n128 by N.
template <int N, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float d[][4], const uint32_t a[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "N");
  if constexpr (N == 128)
    wgmma_rs_n128<TRANS_B>(d, a, b);
  else
    wgmma_rs_n64<TRANS_B>(d, a, b);
}

// ---------------------------------------------------------------------------
// The dense masks of the flash kernels (flash_fwd.cu, flash_bwd.cu), ku's
// _fwd_kernel / _bwd_*_kernel clauses, for one batch row in 64 x 64 tiles.
// ---------------------------------------------------------------------------

struct DenseMask {
  static constexpr int kT = 64;  // rows of a query or key tile
  int n, kn;                     // queries and keys of the row
  int qo, ko;                    // global positions of query 0 and key 0
  int causal, window;            // window <= 0: none
  const int* seg_q;              // the row's (N) and (KN) segment ids, or null
  const int* seg_k;

  static __device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
  }

  // Whether the pair (query qi, key ki) is live: inside N and KN, in one
  // segment, not in the causal future, inside the window.
  __device__ __forceinline__ bool pair(int qi, int ki) const {
    if (qi >= n || ki >= kn) return false;
    if (seg_q && __ldg(seg_q + qi) != __ldg(seg_k + ki)) return false;
    if (causal && ko + ki > qo + qi) return false;
    return window <= 0 || (qo + qi) - (ko + ki) < window;
  }

  // Whether every pair of the tile at queries q0.. x keys k0.. is live: no
  // segments, and its corners pass every other clause.
  __device__ __forceinline__ bool full(int q0, int k0) const {
    return !seg_q && q0 + kT <= n && k0 + kT <= kn &&
           (!causal || ko + k0 + kT - 1 <= qo + q0) &&
           (window <= 0 || (qo + q0 + kT - 1) - (ko + k0) < window);
  }

  // The key tiles [lo, hi) that may hold a live pair for queries [q0, q1]:
  // at or below the causal edge of q1, at or above the window's lower edge
  // of q0 (ku's _live_fwd). Empty when lo >= hi.
  __device__ __forceinline__ void key_tiles(int q0, int q1, int& lo, int& hi) const {
    lo = 0;
    hi = (kn + kT - 1) / kT;
    if (causal) {
      const int kmax = qo + q1 - ko;
      hi = kmax < 0 ? 0 : min(hi, kmax / kT + 1);
    }
    if (window > 0) lo = max(0, floor_div(qo + q0 - (window - 1) - ko, kT));
  }

  // The query tiles [lo, hi) that may hold a live pair for keys [k0, k1]:
  // the same rule read from the key side.
  __device__ __forceinline__ void query_tiles(int k0, int k1, int& lo, int& hi) const {
    lo = 0;
    hi = (n + kT - 1) / kT;
    if (causal) lo = max(0, floor_div(ko + k0 - qo, kT));
    if (window > 0) {
      const int qmax = window - 1 + ko + k1 - qo;
      hi = qmax < 0 ? 0 : min(hi, qmax / kT + 1);
    }
  }
};

// The score x = (q . k) * scale capped as ku caps it, cap * tanh(x / cap)
// when softcap > 0; dcap = 1 - (x / cap)^2 from the capped value (the
// backward's factor; 1 without a cap).
__device__ __forceinline__ float capped(float x, float softcap, float& dcap) {
  dcap = 1.f;
  if (softcap > 0.f) {
    x = softcap * tanhf(x / softcap);
    const float y = x / softcap;
    dcap = 1.f - y * y;
  }
  return x;
}

}  // namespace attn_mma
