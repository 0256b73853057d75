// One CD-k step on a persistent cooperative grid, shared by the
// single-device run (cd_gibbs.cu, kernel #1) and the data-parallel
// statistics step (cd_gibbs_dp.cu, kernel #2): the "global route", for the
// shapes whose W the cluster route (cd_cluster.cuh) cannot hold in one
// cluster. It computes what the cluster route computes, with the same
// Philox draws (cd_gibbs_chain.cuh), and like it runs each of a step's
// 2k + 3 products once over all the batch rows, on the tensor cores in
// 3xTF32 (cd_cluster.cuh's product: each operand split into a tf32 high
// and low part, hi lo + lo hi + hi hi summed in f32, the low parts of
// operands that are tf32 already skipped).
//
// Layout. W is cut into tiles of tv x th (multiples of 8, the plan's
// choice: make_plan); tile (iv, ih) covers W's rows iv tv .. and columns
// ih th ..; block b of the grid's G blocks (one an SM, 512 threads) owns
// tiles b, b + G, .... Where a block's tiles fit its shared memory they
// stay there for the whole run ("resident"); otherwise the block reads
// each tile from global memory (L2) once a product. The batch is taken in
// chunks of bc rows (all of it when the buffers fit). A step is seven
// phases, a grid barrier after each of the first six:
//   (1) each tile's owner: P_iv = v_pos[:, rows of the tile] W_tile, into
//       global scratch (the partial activations of the tile's columns);
//   (b) items of (row, 128 columns), each on a group of gh warps: the nv
//       partials summed in order (a run a warp, the runs in warp order),
//       h_pos drawn, into global scratch; the softplus terms of F(v_pos);
//   (2) each tile's owner: Q_ih = h[:, columns of the tile] W_tile^T;
//   (c) items of (row, 128 visible units) on groups of gv warps: the nh
//       partials summed, v_neg drawn; the visible terms of F(v_pos), F(v_neg);
//   (3) as (1) on v_neg;
//   (d) as (b): h_neg, or for k > 1 the next sweep's h, after which (2) to
//       (d) repeat; F(v_neg)'s softplus terms;
//   (u) each tile's owner: dW_tile = [v_pos m; v_neg]^T [h_pos; -h_neg], one
//       product over twice the rows, handed to the emitter; the owners of
//       tiles (0, ih) and (iv, 0) the b_h and b_v sums of their columns and
//       rows; the last block the score's sums.
// Where a block has one tile and one chunk ("keep" plans: the DBN's), (u)
// finds v_pos, v_neg and h_pos in shared memory where (1), (3) and (2) left
// them and reads only h_neg. (u) needs no barrier before the next step's
// (1): a tile's products read only the tile its own block updated. Every
// sum has a fixed order and no atomic is used, so two runs give the same
// bits, and the emitter alone tells kernel #1 (lr times the sums added
// into the parameters) from kernel #2 (the sums written to the step's
// statistics buffer).
//
// What bounds it on an H100: not the (2k+3) 2 B V H operations (0.79 us a
// step at the TF32 peak at the DBN's 784 x 500, batch 100; 2.0 us at
// 500 x 2000) nor the bytes (the partials, nv B H + nh B V + nv B H floats
// a step, written and read once through L2), but latency. A step at
// 784 x 500 takes about 45 us: six grid barriers (about 1.2 us each, plus
// the wait for the slowest block), three product phases of 3-5 us (an
// operand's round trip to L2, then a 3xTF32 product on mma.sync that keeps
// an SM's tensor cores about a fifth busy), three unit phases of 2-4 us, and
// (u) about 9 us. The step before this design ran each batch row's chain
// on one block with W read from L2 once a row and product (3 B V H floats
// a step, 470 MB at 784 x 500; about 298 us).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_gibbs_chain.cuh"
#include "cd_cluster.cuh"

namespace cd {
namespace grid {

namespace cg = cooperative_groups;
namespace cc = cd::cluster;
using cc::kCT;
using cc::kCW;
using cc::round_up;

constexpr int kMaxTile = 256;  // the largest tile side the plan tries
constexpr int kSeg = 128;      // columns of an item of (b) / (c) / (d): a warp's quads
constexpr int kMarks = 14;     // probe timestamps a step (cd_gibbs.cu)

// A global route's shape: the grid's blocks, the tiles, the batch chunk, the
// shared-memory layout (offsets in floats, 16-byte aligned) and the global
// scratch's (offsets in floats from its start).
struct Plan {
  int batch, vdim, hdim, blocks;
  int tv, th, nv, nh, tiles, per;  // tile sides, tile grid, tiles a block at most
  int resident;                    // 1: a block's tiles stay in shared memory
  int bc, chunks;                  // batch rows a chunk, chunks a step
  int keep;                        // 1 tile a block and 1 chunk: (u) finds v_pos,
                                   // v_neg and h_pos where (1), (3), (2) left them
  int ldw, ldv, ldh, ldd;
  int o_w, o_va, o_hb, o_dw, o_bs, o_m, o_r, o_red, floats;
  int vq, hq, segv, segh;          // V, H rounded up to 4; items a row
  int gv, gh;                      // warps an item of (c), of (b) / (d)
  size_t part, x, y, n, vn, sp, vs, scratch;
};

// Takes n floats (rounded up to 16 bytes) at the offset o; returns where.
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += round_up(n, 4);
  return at;
}

__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o += (n + 3) / 4 * 4;
  return at;
}

__host__ __device__ inline void lay_out(Plan& p) {
  int o = 0;
  const int bc8 = round_up(p.bc, 8);
  p.ldw = p.ldh = cc::lead_k(p.th);
  p.ldv = cc::lead_k(p.tv);
  p.ldd = cc::lead_pair(p.th);
  p.o_w = take(o, (p.resident ? p.per : 1) * p.tv * p.ldw);  // W tiles, zero past V, H
  p.o_va = take(o, 2 * bc8 * p.ldv);  // v rows: v_pos (m) then v_neg
  p.o_hb = take(o, 2 * bc8 * p.ldh);  // h rows: h_pos then h, or -h_neg
  p.o_dw = take(o, p.chunks > 1 ? p.tv * p.ldd : 0);  // dW over the chunks
  p.o_bs = take(o, p.tv + p.th);      // the tile's b_v and b_h sums
  p.o_m = take(o, p.bc);              // the chunk's row mask
  p.o_r = take(o, kCW * 32 * 4);      // (b), (c), (d): each warp's partial sums
  p.o_red = take(o, 2 * kCW);         // block sums
  p.floats = o;
}

// Warps that share an item of (b), (c), (d), each summing a run of its n
// partials: the most (a power of 2, at most a block's warps and n / 2) that
// still give every item of the grid's blocks a group at once.
__host__ __device__ inline int item_warps(int items, int n, int blocks) {
  int g = 1;
  while (2 * g <= kCW && 4 * g <= n && (long long)items * 2 * g <= (long long)kCW * blocks)
    g *= 2;
  return g;
}

__host__ __device__ inline void lay_out_scratch(Plan& p) {
  size_t o = 0;
  const size_t B = (size_t)p.batch;
  p.vq = round_up(p.vdim, 4);
  p.hq = round_up(p.hdim, 4);
  p.segv = (p.vdim + kSeg - 1) / kSeg;
  p.segh = (p.hdim + kSeg - 1) / kSeg;
  const size_t pp = (size_t)p.nv * B * p.hq, qq = (size_t)p.nh * B * p.vq;
  p.part = take(o, pp > qq ? pp : qq);  // P (nv, B, hq) or Q (nh, B, vq)
  p.x = take(o, B * p.hq);              // h_pos
  p.y = take(o, B * p.hq);              // a middle sweep's h
  p.n = take(o, B * p.hq);              // h_neg
  p.vn = take(o, B * p.vq);             // v_neg
  p.sp = take(o, 2 * (size_t)p.segh * B);  // softplus sums of F(v_pos), F(v_neg)
  p.vs = take(o, 2 * (size_t)p.segv * B);  // visible terms of F(v_pos), F(v_neg)
  p.scratch = o;
  p.gh = item_warps(p.batch * p.segh, p.nv, p.blocks);
  p.gv = item_warps(p.batch * p.segv, p.nh, p.blocks);
}

// A model of the time a step takes on a plan, in floats moved through L2
// by the busiest block (a tile's products: 5 B tv th multiply-adds, at 5 a
// float; its operands and partials: B (4 tv + 5 th) floats; its W read
// three times where it is not resident; 40,000 for the round trips of each
// chunk of its rows), plus its share of (b), (c), (d)'s partials.
inline long long plan_cost(const Plan& p) {
  const long long B = p.batch, tv = p.tv, th = p.th;
  const long long tile = B * tv * th / 5 + p.bc * (4 * tv + 5 * th) * (long long)p.chunks +
                         (p.resident ? 0 : 3 * tv * th) + 40000LL * p.chunks;
  return p.per * tile + B * (2LL * p.nv * p.hdim + (long long)p.nh * p.vdim) / p.blocks;
}

// The plan at `blocks` blocks: of the tilings whose buffers fit a block's
// shared memory, the one plan_cost puts first; resident tiles where any
// tiling allows them. tiles = 0 if nothing fits.
inline Plan make_plan(int batch, int vdim, int hdim, int blocks) {
  Plan best{};
  long long best_cost = 0;
  const int budget = cc::kBudget / (int)sizeof(float);
  const int tv_max = round_up(vdim, 8) < kMaxTile ? round_up(vdim, 8) : kMaxTile;
  const int th_max = round_up(hdim, 8) < kMaxTile ? round_up(hdim, 8) : kMaxTile;
  for (int resident = 1; resident >= 0 && best.tiles == 0; --resident) {
    for (int tv = 8; tv <= tv_max; tv += 8) {
      for (int th = 8; th <= th_max; th += 8) {
        Plan p{};
        p.batch = batch;
        p.vdim = vdim;
        p.hdim = hdim;
        p.blocks = blocks;
        p.tv = tv;
        p.th = th;
        p.nv = (vdim + tv - 1) / tv;
        p.nh = (hdim + th - 1) / th;
        p.tiles = p.nv * p.nh;
        p.per = (p.tiles + blocks - 1) / blocks;
        p.resident = resident;
        // The whole batch as one chunk if it fits, else the most rows that
        // do, with the dW buffer the chunks add into.
        p.bc = batch;
        p.chunks = 1;
        lay_out(p);
        if (p.floats > budget) {
          p.chunks = 2;
          p.bc = 0;
          lay_out(p);
          const int rows8 = (budget - p.floats) / (2 * (p.ldv + p.ldh) + 1) / 8 * 8;
          if (rows8 < 8) continue;
          p.bc = rows8;
          p.chunks = (batch + rows8 - 1) / rows8;
          lay_out(p);
        }
        const long long cost = plan_cost(p);
        if (best.tiles && cost >= best_cost) continue;
        best = p;
        best_cost = cost;
      }
    }
  }
  if (best.tiles) {
    best.keep = best.per == 1 && best.chunks == 1;
    lay_out_scratch(best);
  }
  return best;
}

// What a block needs for a step.
struct Ctx {
  Plan p;
  const float* w;  // (V, H): the tiles' source
  const float* bh;
  const float* bv;
  float* s;        // the scratch
  int k, mode;
  uint32_t seed, row0;
};

struct Tile {
  int iv, ih, i0, j0, rv, rh;  // place, first row and column, rows and columns in W
};

__device__ __forceinline__ Tile tile_at(const Plan& p, int tile) {
  Tile T;
  T.iv = tile / p.nh;
  T.ih = tile - T.iv * p.nh;
  T.i0 = T.iv * p.tv;
  T.j0 = T.ih * p.th;
  T.rv = min(p.tv, p.vdim - T.i0);
  T.rh = min(p.th, p.hdim - T.j0);
  return T;
}

// The n-th tile this block owns (past the last tile when it owns fewer) and
// the shared-memory offset of its W.
__device__ __forceinline__ int own(int n) { return blockIdx.x + n * gridDim.x; }
__device__ __forceinline__ int w_at(const Plan& p, int n) {
  return p.o_w + (p.resident ? n : 0) * p.tv * p.ldw;
}

// The uniforms of columns 4q .. 4q + 3 of a row (one Philox call: its four
// words; uniform_at's numbers).
__device__ __forceinline__ void draw4(const Ctx& c, uint32_t t, uint32_t stream,
                                      int row, int q, float u[4]) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)q, c.row0 + (uint32_t)row, stream, 0u), c.seed, t);
  u[0] = (float)(r.x >> 8) * (1.0f / 16777216.0f);
  u[1] = (float)(r.y >> 8) * (1.0f / 16777216.0f);
  u[2] = (float)(r.z >> 8) * (1.0f / 16777216.0f);
  u[3] = (float)(r.w >> 8) * (1.0f / 16777216.0f);
}

// Sum of x over the block, in a fixed order; thread 0 has it.
__device__ inline float block_sum(float x, int o_red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) cc::cd_smem[o_red + (threadIdx.x >> 5)] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int q = 0; q < kCW; ++q) total += cc::cd_smem[o_red + q];
  __syncthreads();
  return total;
}

// Rows [r0, r0 + n) x columns [0, width) of the buffer at o (leading
// dimension ld, a multiple of 4) from n rows of src (row stride lds), each
// row times scale[r] where scale is not null, and times sign; zero in the
// columns past `valid`. Each thread has kFill quads of columns in flight, as
// 16-byte loads where src and lds allow them (then the columns from `valid`
// to the end of its quad are read from src: zeros in the scratch, which
// is zero past V and H). Returns true if some value is not a tf32 value
// (its low 13 bits set). No barrier.
constexpr int kFill = 4;
__device__ inline bool copy_rows(int o, int ld, int r0, int n, int width, int valid,
                                 const float* src, size_t lds, const float* scale,
                                 float sign) {
  bool wide = false;
  const int wq = width >> 2, items = n * wq;
  const bool vec = ((size_t)src & 15u) == 0 && lds % 4 == 0;
  for (int e0 = threadIdx.x; e0 < items; e0 += kFill * kCT) {
    float4 x[kFill];
    int at[kFill];
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int e = e0 + u * kCT, r = e / wq, q = 4 * (e - r * wq);
      at[u] = e < items ? o + (r0 + r) * ld + q : -1;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (at[u] < 0 || q >= valid) continue;
      const float* from = src + r * lds + q;
      if (vec) {
        x[u] = __ldcg(reinterpret_cast<const float4*>(from));
      } else {
        x[u].x = __ldcg(from);
        if (q + 1 < valid) x[u].y = __ldcg(from + 1);
        if (q + 2 < valid) x[u].z = __ldcg(from + 2);
        if (q + 3 < valid) x[u].w = __ldcg(from + 3);
      }
      const float f = scale != nullptr ? sign * __ldcg(scale + r) : sign;
      x[u].x *= f;
      x[u].y *= f;
      x[u].z *= f;
      x[u].w *= f;
    }
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      if (at[u] < 0) continue;
      *reinterpret_cast<float4*>(cc::cd_smem + at[u]) = x[u];
      wide |= ((__float_as_uint(x[u].x) | __float_as_uint(x[u].y) |
                __float_as_uint(x[u].z) | __float_as_uint(x[u].w)) & 0x1fffu) != 0u;
    }
  }
  return wide;
}

// Rows [r0, r1) x columns [0, width) of the buffer at o set to zero.
__device__ inline void zero_rows(int o, int ld, int r0, int r1, int width) {
  for (int e = threadIdx.x; e < (r1 - r0) * width; e += kCT) {
    const int r = e / width;
    cc::cd_smem[o + (r0 + r) * ld + e - r * width] = 0.f;
  }
}

// Whether every value the block copied is a tf32 value, after a barrier.
__device__ __forceinline__ bool all_exact(bool wide) { return !__syncthreads_or(wide); }

// cd_cluster.cuh's product in 3xTF32 with B's low part always taken (W's,
// or h_neg's, are not tf32 values; where they are, their low part is zero
// and taking it changes no bit), A's skipped where a_exact: each case
// compiled apart, so that neither carries the other's branches.
template <class Epi>
__device__ __forceinline__ void product(bool a_exact, int M, int N, int K, int a, int a_m,
                                        int a_k, int b, int b_k, int b_n, const Epi& epi) {
  if (a_exact) {
    cc::product<1, 4>(M, N, K, a, a_m, a_k, b, b_k, b_n, true, false, epi);
  } else {
    cc::product<1, 4>(M, N, K, a, a_m, a_k, b, b_k, b_n, false, false, epi);
  }
}

// W's tile into shared memory at o, zero past V and H; after a barrier.
__device__ inline void load_w(const Ctx& c, const Tile& T, int o) {
  const Plan& p = c.p;
  copy_rows(o, p.ldw, 0, T.rv, p.th, T.rh, c.w + (size_t)T.i0 * p.hdim + T.j0,
            (size_t)p.hdim, nullptr, 1.f);
  zero_rows(o, p.ldw, T.rv, p.tv, p.th);
  __syncthreads();
}

// Every tile this block owns into shared memory (resident plans).
__device__ inline void load_tiles(const Ctx& c) {
  for (int n = 0; n < c.p.per && own(n) < c.p.tiles; ++n)
    load_w(c, tile_at(c.p, own(n)), w_at(c.p, n));
}

// Products' epilogue into global memory: C[m, n] at p[m * ld + n].
struct Store {
  float* p;
  int ld;
  __device__ void put2(int m, int n, float v0, float v1, bool both) const {
    float* at = p + (size_t)m * ld + n;
    if (both) {
      *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
    } else {
      at[0] = v0;
    }
  }
};

// (u)'s epilogue with the whole batch in one chunk: each dW entry to the
// emitter, with its place in shared memory (resident plans) and in W.
template <class Emit>
struct EmitW {
  Emit emit;
  int o, ld, i0, j0, hdim;
  __device__ void put2(int m, int n, float v0, float v1, bool both) const {
    const size_t g = (size_t)(i0 + m) * hdim + j0 + n;
    emit.weight(o < 0 ? -1 : o + m * ld + n, g, v0);
    if (both) emit.weight(o < 0 ? -1 : o + m * ld + n + 1, g + 1, v1);
  }
};

// Column sums over rows [r0, r1) of the buffer at o (leading dimension ld),
// `cols` of them, added times sign into shared memory at acc + col: eight lanes a
// column, each over every eighth row, in a fixed order.
__device__ inline void column_sums(int o, int ld, int cols, int r0, int r1, int acc,
                                   float sign) {
  const int part = threadIdx.x & 7;
  for (int c0 = 0; c0 < cols; c0 += kCT / 8) {
    const int col = c0 + (threadIdx.x >> 3);
    float s = 0.f;
    if (col < cols)
      for (int r = r0 + part; r < r1; r += 8) s += cc::cd_smem[o + r * ld + col];
    s = cc::sum8(s);
    if (col < cols && part == 0) cc::cd_smem[acc + col] += sign * s;
  }
}

// (1) / (3): for each tile the block owns, P_iv[rows, columns of the tile] =
// src[rows, rows of the tile] W_tile into the partials; src is v_pos (row
// stride V) or v_neg (row stride vq). On keep plans v_neg's rows go after
// v_pos's (`second`), where (u) finds both. Returns whether every value of
// src the block read is a tf32 value.
__device__ inline bool visible_products(const Ctx& c, const float* src, int ld,
                                        bool second) {
  const Plan& p = c.p;
  float* part = c.s + p.part;
  bool all = true;
  for (int n = 0; n < p.per && own(n) < p.tiles; ++n) {
    const Tile T = tile_at(p, own(n));
    const int ow = w_at(p, n);
    if (!p.resident) load_w(c, T, ow);
    for (int b0 = 0; b0 < p.batch; b0 += p.bc) {
      const int rows = min(p.bc, p.batch - b0);
      const int o = p.o_va + (p.keep && second ? rows * p.ldv : 0);
      const bool exact = all_exact(copy_rows(o, p.ldv, 0, rows, p.tv, T.rv,
                                             src + (size_t)b0 * ld + T.i0, (size_t)ld,
                                             nullptr, 1.f));
      product(exact, rows, T.rh, p.tv, o, p.ldv, 1, ow, p.ldw, 1,
              Store{part + ((size_t)T.iv * p.batch + b0) * p.hq + T.j0, p.hq});
      all = all && exact;
      __syncthreads();
    }
  }
  return all;
}

// (2): for each tile the block owns, Q_ih[rows, rows of the tile] =
// h[rows, columns of the tile] W_tile^T into the partials. On keep plans
// h_pos's rows stay first for (u), a later sweep's h goes after them.
__device__ inline void hidden_products(const Ctx& c, const float* h, bool second) {
  const Plan& p = c.p;
  float* part = c.s + p.part;
  for (int n = 0; n < p.per && own(n) < p.tiles; ++n) {
    const Tile T = tile_at(p, own(n));
    const int ow = w_at(p, n);
    if (!p.resident) load_w(c, T, ow);
    for (int b0 = 0; b0 < p.batch; b0 += p.bc) {
      const int rows = min(p.bc, p.batch - b0);
      const int o = p.o_hb + (p.keep && second ? rows * p.ldh : 0);
      const bool exact = all_exact(copy_rows(o, p.ldh, 0, rows, p.th, T.rh,
                                             h + (size_t)b0 * p.hq + T.j0, (size_t)p.hq,
                                             nullptr, 1.f));
      product(exact, rows, T.rv, p.th, o, p.ldh, 1, ow, 1, p.ldw,
              Store{part + ((size_t)T.ih * p.batch + b0) * p.vq + T.i0, p.vq});
      __syncthreads();
    }
  }
}

// Rows [0, rows) of the buffer at o times the row scale in shared memory at
// o_s, in place: a warp a row. No barrier.
__device__ inline void scale_rows(int o, int ld, int rows, int width, int o_s) {
  for (int r = threadIdx.x >> 5; r < rows; r += kCW) {
    const float m = cc::cd_smem[o_s + r];
    for (int q = threadIdx.x & 31; q < width; q += 32) cc::cd_smem[o + r * ld + q] *= m;
  }
}

// s += the n partials at at, at + stride, ... (a quad each), in order; the
// loads kPart at a time, all in flight together.
constexpr int kPart = 4;
__device__ __forceinline__ void sum_parts(const float* at, size_t stride, int n,
                                          float s[4]) {
  for (int p0 = 0; p0 < n; p0 += kPart) {
    float4 x[kPart];
#pragma unroll
    for (int u = 0; u < kPart; ++u)
      if (p0 + u < n) x[u] = __ldcg(reinterpret_cast<const float4*>(at + (p0 + u) * stride));
#pragma unroll
    for (int u = 0; u < kPart; ++u) {
      if (p0 + u >= n) break;
      s[0] += x[u].x;
      s[1] += x[u].y;
      s[2] += x[u].z;
      s[3] += x[u].w;
    }
  }
}

// An item's activations (or statistics) in a group of g warps of the block:
// warp `sub` of the group sums a run of the n partials at at, at + stride,
// ... in order, and the group's first warp adds the runs up in warp order.
// Every thread of the block calls it at once (two barriers where g > 1);
// returns true on the first warp of a group whose item is live (it < items),
// which holds the sums in s.
__device__ inline bool item_sums(const Plan& p, const float* at, size_t stride, bool live,
                                 int n, int g, float s[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = warp % g;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  if (live) {
    const int per = (n + g - 1) / g, p0 = sub * per, p1 = min(n, p0 + per);
    if (p1 > p0) sum_parts(at + (size_t)p0 * stride, stride, p1 - p0, s);
  }
  if (g == 1) return true;
  float4* red = reinterpret_cast<float4*>(cc::cd_smem + p.o_r);
  red[warp * 32 + lane] = make_float4(s[0], s[1], s[2], s[3]);
  __syncthreads();
  if (sub == 0) {
    for (int u = 1; u < g; ++u) {
      const float4 x = red[(warp + u) * 32 + lane];
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
    }
  }
  __syncthreads();
  return sub == 0;
}

// (b) / (d): items of (row, 128 columns) over groups of gh warps of the
// grid; the activations from the nv partials (item_sums; doubled in complex
// mode, plus b_h), and kind 0: h_pos; 1: a middle sweep's h; 2: h_neg,
// written a quad at a time (zero past H). With slot >= 0 the item's
// softplus terms of F go to the scratch's slot.
__device__ inline void hidden_units(const Ctx& c, uint32_t t, const float* mask,
                                    int kind, int sweep, int slot) {
  const Plan& p = c.p;
  const int lane = threadIdx.x & 31;
  const float* part = c.s + p.part;
  float* dst = c.s + (kind == 0 ? p.x : kind == 1 ? p.y : p.n);
  const uint32_t stream = kind == 0 ? 0u : 3u + 3u * (uint32_t)sweep;
  const size_t stride = (size_t)p.batch * p.hq;
  const int items = p.batch * p.segh, groups = kCW / p.gh;
  for (int base = blockIdx.x * groups; base < items; base += gridDim.x * groups) {
    const int it = min(base + (threadIdx.x >> 5) / p.gh, items - 1);
    const int b = it / p.segh, sg = it - b * p.segh;
    const int q = sg * 32 + lane, j0 = 4 * q;
    const bool live = base + (threadIdx.x >> 5) / p.gh < items;
    float s[4];
    if (!item_sums(p, part + (size_t)b * p.hq + j0, stride, live && j0 < p.hdim, p.nv,
                   p.gh, s) || !live)
      continue;
    float sp = 0.f;
    if (j0 < p.hdim) {
      const float m = __ldcg(mask + b);
      float u[4];
      if (kind != 2) draw4(c, t, stream, b, q, u);
      float h[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        h[v] = 0.f;
        if (j0 + v >= p.hdim) continue;
        const float act =
            (c.mode == kComplex ? 2.0f * s[v] : s[v]) + __ldcg(c.bh + j0 + v);
        if (kind == 0) {
          const float pr = c.mode == kGaussian ? fmaxf(act, 0.f) : sigmoid(act);
          h[v] = u[v] < pr ? m : 0.f;
        } else {
          const float hn = sigmoid(act) * m;
          if (kind == 2) {
            h[v] = hn;
          } else {
            const float pr = c.mode == kGaussian ? fmaxf(act, 0.f) * m : hn;
            h[v] = u[v] < pr ? 1.f : 0.f;
          }
        }
        if (slot >= 0) sp += softplus(act);
      }
      *reinterpret_cast<float4*>(dst + (size_t)b * p.hq + j0) =
          make_float4(h[0], h[1], h[2], h[3]);
    }
    if (slot >= 0) {
      sp = warp_sum(sp);
      if (lane == 0) c.s[p.sp + ((size_t)slot * p.segh + sg) * p.batch + b] = sp;
    }
  }
}

// (c): items of (row, 128 visible units) over groups of gv warps; the
// statistic from the nh partials (item_sums), plus b_v; v_neg of sweep `sweep` drawn, times
// the row mask (zero past V). At sweep 0 the item's visible terms of
// F(v_pos) and F(v_neg) go to the scratch.
__device__ inline void visible_units(const Ctx& c, uint32_t t, const float* v,
                                     const float* mask, int sweep) {
  const Plan& p = c.p;
  const int lane = threadIdx.x & 31;
  const float* part = c.s + p.part;
  float* dst = c.s + p.vn;
  const size_t stride = (size_t)p.batch * p.vq;
  const bool cx = c.mode == kComplex;
  const int items = p.batch * p.segv, groups = kCW / p.gv;
  for (int base = blockIdx.x * groups; base < items; base += gridDim.x * groups) {
    const int it = min(base + (threadIdx.x >> 5) / p.gv, items - 1);
    const int b = it / p.segv, sg = it - b * p.segv;
    const int q = sg * 32 + lane, i0 = 4 * q;
    const bool live = base + (threadIdx.x >> 5) / p.gv < items;
    float s[4];
    if (!item_sums(p, part + (size_t)b * p.vq + i0, stride, live && i0 < p.vdim, p.nh,
                   p.gv, s) || !live)
      continue;
    float fp = 0.f, fn = 0.f;
    if (i0 < p.vdim) {
      const float m = __ldcg(mask + b);
      float u1[4], u2[4];
      draw4(c, t, 1u + 3u * (uint32_t)sweep, b, q, u1);
      if (c.mode != kBernoulli) draw4(c, t, 2u + 3u * (uint32_t)sweep, b, q, u2);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = 0.f;
        const int i = i0 + e;
        if (i >= p.vdim) continue;
        const float bv = __ldcg(c.bv + i), stat = s[e] + bv;
        float y;
        if (c.mode == kBernoulli) {
          y = u1[e] < sigmoid(stat) ? 1.f : 0.f;
        } else {
          const float z = sqrtf(-2.0f * logf(fmaxf(u1[e], 1e-7f))) *
                          cosf(6.283185307179586f * u2[e]);
          y = stat + (cx ? 0.7071067811865476f * z : z);
        }
        x[e] = y * m;
        if (sweep == 0) {
          const float vp = __ldcg(v + (size_t)b * p.vdim + i);
          if (cx) {
            fp += (vp - bv) * (vp - bv);
            fn += (x[e] - bv) * (x[e] - bv);
          } else {
            fp += vp * bv;
            fn += x[e] * bv;
          }
        }
      }
      *reinterpret_cast<float4*>(dst + (size_t)b * p.vq + i0) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    if (sweep == 0) {
      fp = warp_sum(fp);
      fn = warp_sum(fn);
      if (lane == 0) {
        c.s[p.vs + (size_t)sg * p.batch + b] = fp;
        c.s[p.vs + ((size_t)p.segv + sg) * p.batch + b] = fn;
      }
    }
  }
}

// (u): for each tile the block owns, dW_tile over the step's rows to
// emit.weight(shared-memory index of the entry or -1, index in W, sum), the
// b_h sums of its columns (tiles (0, ih)) to emit.hidden and the b_v sums
// of its rows (tiles (iv, 0)) to emit.visible; the last block the score's
// sums, sum |F(v_pos) - F(v_neg)| m and sum m, to emit.score.
template <class Emit>
__device__ inline void update(const Ctx& c, const float* v, const float* mask,
                              bool exact, const Emit& emit) {
  const Plan& p = c.p;
  const float* x = c.s + p.x;
  const float* hn = c.s + p.n;
  const float* vn = c.s + p.vn;
  for (int n = 0; n < p.per && own(n) < p.tiles; ++n) {
    const Tile T = tile_at(p, own(n));
    const int ow = p.resident ? w_at(p, n) : -1;
    for (int e = threadIdx.x; e < p.tv + p.th; e += kCT) cc::cd_smem[p.o_bs + e] = 0.f;
    if (p.chunks > 1)
      for (int e = threadIdx.x; e < p.tv * p.ldd; e += kCT) cc::cd_smem[p.o_dw + e] = 0.f;
    for (int b0 = 0; b0 < p.batch; b0 += p.bc) {
      const int rows = min(p.bc, p.batch - b0), K = round_up(2 * rows, 8);
      zero_rows(p.o_va, p.ldv, 2 * rows, K, p.tv);
      zero_rows(p.o_hb, p.ldh, 2 * rows, K, p.th);
      bool va;  // every value of [v_pos m; v_neg] a tf32 value
      if (p.keep) {  // v_pos, v_neg and h_pos are in place: v_pos times m
        bool odd = false;  // a mask value other than 0 and 1
        for (int b = threadIdx.x; b < rows; b += kCT) {
          const float m = __ldcg(mask + b0 + b);
          cc::cd_smem[p.o_m + b] = m;
          odd |= m != 0.f && m != 1.f;
        }
        const bool m01 = !__syncthreads_or(odd);  // every thread reaches the barrier
        va = exact && m01;
        scale_rows(p.o_va, p.ldv, rows, p.tv, p.o_m);
        copy_rows(p.o_hb, p.ldh, rows, rows, p.th, T.rh, hn + (size_t)b0 * p.hq + T.j0,
                  (size_t)p.hq, nullptr, -1.f);
        __syncthreads();
      } else {
        const bool wide =
            copy_rows(p.o_va, p.ldv, 0, rows, p.tv, T.rv, v + (size_t)b0 * p.vdim + T.i0,
                      (size_t)p.vdim, mask + b0, 1.f) |
            copy_rows(p.o_va, p.ldv, rows, rows, p.tv, T.rv, vn + (size_t)b0 * p.vq + T.i0,
                      (size_t)p.vq, nullptr, 1.f);
        copy_rows(p.o_hb, p.ldh, 0, rows, p.th, T.rh, x + (size_t)b0 * p.hq + T.j0,
                  (size_t)p.hq, nullptr, 1.f);
        copy_rows(p.o_hb, p.ldh, rows, rows, p.th, T.rh, hn + (size_t)b0 * p.hq + T.j0,
                  (size_t)p.hq, nullptr, -1.f);
        va = all_exact(wide);
      }
      if (p.chunks == 1) {
        product(va, T.rv, T.rh, K, p.o_va, 1, p.ldv, p.o_hb, p.ldh, 1,
                EmitW<Emit>{emit, ow, p.ldw, T.i0, T.j0, p.hdim});
      } else {
        product(va, T.rv, T.rh, K, p.o_va, 1, p.ldv, p.o_hb, p.ldh, 1,
                cc::Accumulate{p.o_dw, p.ldd, 1.f});
      }
      if (T.ih == 0) {
        column_sums(p.o_va, p.ldv, T.rv, 0, rows, p.o_bs, 1.f);
        column_sums(p.o_va, p.ldv, T.rv, rows, 2 * rows, p.o_bs, -1.f);
      }
      if (T.iv == 0) column_sums(p.o_hb, p.ldh, T.rh, 0, 2 * rows, p.o_bs + p.tv, 1.f);
      __syncthreads();
    }
    if (p.chunks > 1) {
      for (int e = threadIdx.x; e < T.rv * T.rh; e += kCT) {
        const int i = e / T.rh, j = e - i * T.rh;
        emit.weight(ow < 0 ? -1 : ow + i * p.ldw + j,
                    (size_t)(T.i0 + i) * p.hdim + T.j0 + j, cc::cd_smem[p.o_dw + i * p.ldd + j]);
      }
    }
    if (T.ih == 0)
      for (int i = threadIdx.x; i < T.rv; i += kCT) emit.visible(T.i0 + i, cc::cd_smem[p.o_bs + i]);
    if (T.iv == 0)
      for (int j = threadIdx.x; j < T.rh; j += kCT)
        emit.hidden(T.j0 + j, cc::cd_smem[p.o_bs + p.tv + j]);
    __syncthreads();
  }
  if (blockIdx.x == gridDim.x - 1) {
    // A thread a row: the row's terms of F from every item, summed in item
    // order, kPart loads in flight at a time.
    const bool cx = c.mode == kComplex;
    float d = 0.f, msum = 0.f;
    for (int b = threadIdx.x; b < p.batch; b += kCT) {
      float f[4];  // softplus terms of v_pos, v_neg; visible terms of v_pos, v_neg
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = e < 2 ? p.segh : p.segv;
        const float* at = c.s + (e < 2 ? p.sp : p.vs) + ((size_t)(e & 1) * n) * p.batch + b;
        f[e] = 0.f;
        for (int g0 = 0; g0 < n; g0 += kPart) {
          float x[kPart];
#pragma unroll
          for (int u = 0; u < kPart; ++u)
            if (g0 + u < n) x[u] = __ldcg(at + (size_t)(g0 + u) * p.batch);
#pragma unroll
          for (int u = 0; u < kPart; ++u) {
            if (g0 + u >= n) break;
            f[e] += x[u];
          }
        }
      }
      const float fpos = cx ? f[2] - f[0] : -(f[2] + f[0]);
      const float fneg = cx ? f[3] - f[1] : -(f[3] + f[1]);
      const float m = __ldcg(mask + b);
      d += fabsf(fpos - fneg) * m;
      msum += m;
    }
    d = block_sum(d, p.o_red);
    msum = block_sum(msum, p.o_red);
    if (threadIdx.x == 0) emit.score(d, msum);
  }
}

#ifdef CD_PROBE
// Probe builds stamp a mark once the whole block has reached it: (steps,
// blocks, kMarks) stamps.
#define GRID_MARK(t, mark)                                                     \
  do {                                                                         \
    __syncthreads();                                                           \
    if (threadIdx.x == 0 && cc::g_probe && (int)(t) < cc::g_probe_steps)       \
      cc::g_probe[((size_t)(t) * gridDim.x + blockIdx.x) * kMarks + (mark)] =  \
          cc::globaltimer();                                                   \
  } while (0)
#else
#define GRID_MARK(t, mark) \
  do {                     \
  } while (0)
#endif

// One step on the grid: v, mask are the step's rows (batch, V) and mask.
// For k > 1 the sweeps' marks are the last sweep's.
template <class Emit>
__device__ void grid_step(const Ctx& c, uint32_t t, const float* v, const float* mask,
                          const Emit& emit) {
  const Plan& p = c.p;
  cg::grid_group g = cg::this_grid();
  GRID_MARK(t, 0);
  // Whether v_pos and the last v_neg the block read are tf32 values: on
  // keep plans (u) takes them where (1) and (3) left them.
  const bool vpos_exact = visible_products(c, v, p.vdim, false);  // (1)
  bool vneg_exact = true;
  GRID_MARK(t, 1);
  g.sync();
  GRID_MARK(t, 2);
  hidden_units(c, t, mask, 0, 0, 0);  // (b): h_pos, softplus of F(v_pos)
  GRID_MARK(t, 3);
  g.sync();
  GRID_MARK(t, 4);
  for (int s = 0; s < c.k; ++s) {
    hidden_products(c, c.s + (s == 0 ? p.x : p.y), s > 0);  // (2)
    GRID_MARK(t, 5);
    g.sync();
    GRID_MARK(t, 6);
    visible_units(c, t, v, mask, s);  // (c)
    GRID_MARK(t, 7);
    g.sync();
    GRID_MARK(t, 8);
    vneg_exact = visible_products(c, c.s + p.vn, p.vq, true);  // (3)
    GRID_MARK(t, 9);
    g.sync();
    GRID_MARK(t, 10);
    hidden_units(c, t, mask, s == c.k - 1 ? 2 : 1, s, s == 0 ? 1 : -1);  // (d)
    GRID_MARK(t, 11);
    g.sync();
    GRID_MARK(t, 12);
  }
  update(c, v, mask, vpos_exact && vneg_exact, emit);  // (u)
  GRID_MARK(t, 13);
}

// Host side.

// The plan at this shape on `blocks` blocks, made once and kept until a
// call at another shape; no CUDA call.
inline Plan plan_at(int batch, int vdim, int hdim, int blocks) {
  static int key[4] = {-1, -1, -1, -1};
  static Plan last;
  if (key[0] != batch || key[1] != vdim || key[2] != hdim || key[3] != blocks) {
    last = make_plan(batch, vdim, hdim, blocks);
    key[0] = batch;
    key[1] = vdim;
    key[2] = hdim;
    key[3] = blocks;
  }
  return last;
}

// The global route's grid for `kernel` at this shape on `device`: one block
// an SM, the plan at that count (plan_at). Sets the kernel's shared-memory
// attribute (the budget, so that another shape needs no new one) and checks
// that a block of the plan fits an SM. Fills *plan and returns 0, or a CUDA
// error code.
template <class Kernel>
int choose(Kernel kernel, int batch, int vdim, int hdim, int device, Plan* plan) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan_at(batch, vdim, hdim, sms);
  if (p.tiles == 0) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cc::kBudget);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCT,
                                                    (size_t)p.floats * sizeof(float));
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *plan = p;
  return 0;
}

}  // namespace grid
}  // namespace cd
