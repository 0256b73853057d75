// One CD-k step on a thread-block cluster, shared by the single-device run
// (cd_gibbs.cu, kernel #1) and the data-parallel statistics step
// (cd_gibbs_dp.cu, kernel #2): the "cluster route". It computes what
// cd_gibbs_chain.cuh's two phases compute (the "global route"), with the
// same Philox draws, but as ku's TPU kernel runs a step
// (ku/pallas/cd_gibbs.py:5-17): the parameters stay on chip, each product
// runs once over the batch rows, and the barriers are the cluster's.
//
// Layout. The cluster has C blocks of 512 threads (C = 16, or 8 where the
// card cannot co-schedule 16). Block r owns a contiguous slice of the
// visible rows, rows_r (split_start / split_count: the first V % C blocks
// take one row more), and holds W[rows_r, :] and b_v[rows_r] in its shared
// memory for the whole run; it also owns a contiguous slice of the hidden
// columns, cols_r, split the same way, and b_h[cols_r]. The batch is taken
// in tiles of bt rows (the plan's largest tile whose buffers fit 227 KB).
// For each tile, with X the (tile, H) hidden matrix every block holds:
//   (1) P_r = v_pos[:, rows_r] W_r into the block's X buffer, which holds
//       no X at that time; cluster barrier;
//   (b) the owner of cols_r reads those columns of every block's P_q
//       through distributed shared memory (DSMEM) and sums them in rank
//       order; cluster barrier (every P_q read); it draws h_pos and pushes
//       it into every block's X; each block its terms of F(v_pos) a row
//       (softplus over cols_r, visible terms over rows_r); cluster barrier;
//   (2) S = X W_r^T and the draw of v_neg[:, rows_r], local; the visible
//       terms of F(v_neg);
//   (e) dW_r += (v_pos m)[:, rows_r]^T X, local; the next tile's rows are
//       copied in (cp.async) while the rest of the tile runs;
//   (3) as (1) on v_neg; cluster barrier; (g) as (b): h_neg (or the next
//       sweep's h for k > 1) pushed into X, the softplus terms of F(v_neg);
//       cluster barrier; k > 1 repeats (2), (3), (g);
//   (i) dW_r -= v_neg[:, rows_r]^T X, local; block 0 sums each row's free
//       energies over the blocks' shares (pushed to it in (g)) in rank
//       order, and the score terms.
// A ones column beside v_pos and v_neg makes row nr of dW the b_h sums
// (every block computes the same row; the owner of a column reads it). At
// the step's end the emitter takes dW_r, the b_v sums of rows_r, the b_h
// sums of cols_r and block 0's score sums: kernel #1's adds lr times them
// into the parameters in shared memory, kernel #2's writes them to the
// step's statistics buffer. Every sum has a fixed order, so both kernels
// compute the same bits.
//
// The five products run on the tensor cores in 3xTF32 (mma.sync m16n8k8:
// each operand split into a tf32 high part and a low part, hi lo + lo hi +
// hi hi summed in f32), skipping the low parts of operands that are tf32
// already (the binary data, h_pos, the sampled h and the Bernoulli v_neg).
//
// What bounds it on an H100 (PERF.md): not the 67 TFLOP/s f32
// bound (1.9 us of products a step at the RBM's shape) but latency and the
// legacy tensor-core path: a 64 x 128 x 56 product takes about 3 us in
// 3xTF32 (1.4 us in one pass) on one SM, a cluster barrier 0.56-0.82 us, a
// DSMEM round trip 0.29 us, and each tile of a step pays six barriers
// and two exchanges of 64 KB a block through DSMEM. Sharing one buffer
// between the partials and X lets the RBM's whole batch of 128 rows be one
// tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_gibbs_chain.cuh"

namespace cd {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int kBudget = 232448;  // bytes of shared memory a block may use
constexpr int kMaxCluster = 16;
constexpr int kCT = 512;        // threads a block
constexpr int kCW = kCT / 32;   // warps a block
constexpr int kMarks = 20;  // probe timestamps a tile (cd_gibbs.cu)

__host__ __device__ inline int split_start(int n, int parts, int r) {
  const int base = n / parts, extra = n % parts;
  return r * base + (r < extra ? r : extra);
}

__host__ __device__ inline int split_count(int n, int parts, int r) {
  return n / parts + (r < n % parts ? 1 : 0);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A cluster route's shape: C blocks, the largest slices nr (rows) and hc
// (columns), the batch tile bt and its count, the padded extents (kp: nr
// to 8; hp: H to 8; bt8: bt to 8: the products' depths are multiples of
// 8), the leading dimensions and the offsets (in floats, 16-byte aligned)
// of every shared-memory buffer. The ones column of the v tiles
// is column nr (W's row nr is zero, so the activations never see it).
// ku_torch/kernels/cd_gibbs.py::cluster_plan computes the same numbers.
struct Plan {
  int batch, vdim, hdim, C;
  int nr, hc, bt, tiles, kp, hp, bt8;
  int ldw, ldv, ldx, ldp;
  int o_w, o_vp, o_vn, o_x, o_dw, o_bvs, o_bv, o_bh, o_fe, o_fr, o_m, o_sp,
      o_red, floats;
};

// Leading dimensions: an operand read along k is = 4 (mod 8), so that the
// 32 lanes of an m16n8k8 fragment read 32 banks when k is the contiguous
// axis (two ways at most when it is not); the partials and dW are = 8
// (mod 32), so that the epilogues' pairs of columns take one 8-byte
// access without bank conflicts.
__host__ __device__ inline int lead_k(int n) { return round_up(n, 8) + 4; }
__host__ __device__ inline int lead_pair(int n) { return round_up(n, 32) + 8; }

__host__ __device__ inline void lay_out(Plan& p) {
  int o = 0;
  auto take = [&o](int n) {
    const int at = o;
    o += round_up(n, 4);
    return at;
  };
  p.o_w = take(max(p.kp, p.nr + 1) * p.ldw);  // W[rows_r, :], zero elsewhere
  p.o_vp = take(p.bt8 * p.ldv);    // v_pos tile, ones at column nr
  p.o_vn = take(p.bt8 * p.ldv);    // v_neg tile, likewise
  // X (h_pos, h, h_neg; zero past H and past the tile's rows) and, while
  // X is dead, the block's partial activations (rows of ldp).
  p.o_x = take(max(p.bt8 * p.ldx, p.bt * p.ldp));
  p.o_dw = take((p.nr + 1) * p.ldp);  // dW_r; row nr: the b_h sums
  p.o_bvs = take(p.nr);            // b_v sums
  p.o_bv = take(p.nr);
  p.o_bh = take(p.hc);
  p.o_fe = take(4 * p.bt);         // free-energy terms, 4 a row
  p.o_fr = take(2 * p.C * p.bt);   // block 0: each block's F(v_pos), F(v_neg) a row
  p.o_m = take(p.bt);              // the tile's mask
  p.o_sp = take(p.bt * p.hc);      // the owner's activations / score scratch
  p.o_red = take(4);               // the step's score sums
  p.floats = o;
}

// The plan at cluster size C: the largest batch tile whose buffers fit the
// budget, bt = 0 if none does.
inline Plan make_plan(int batch, int vdim, int hdim, int C) {
  Plan p{};
  p.batch = batch;
  p.vdim = vdim;
  p.hdim = hdim;
  p.C = C;
  p.nr = (vdim + C - 1) / C;
  p.hc = (hdim + C - 1) / C;
  p.kp = round_up(p.nr, 8);
  p.hp = round_up(hdim, 8);
  p.ldw = lead_k(p.hp);
  p.ldv = lead_k(max(p.kp, p.nr + 1));
  p.ldx = lead_k(p.hp);
  p.ldp = lead_pair(hdim);
  for (int tiles = 1; tiles <= batch; ++tiles) {
    p.bt = (batch + tiles - 1) / tiles;
    p.tiles = (batch + p.bt - 1) / p.bt;
    p.bt8 = round_up(p.bt, 8);
    lay_out(p);
    if ((size_t)p.floats * sizeof(float) <= (size_t)kBudget) return p;
  }
  p.bt = p.tiles = 0;
  return p;
}

extern __shared__ __align__(16) float cd_smem[];

// What a block needs to know for the whole run.
struct Ctx {
  Plan p;
  int r;         // rank in the cluster
  int i0, nrr;   // rows_r
  int j0, hcr;   // cols_r
  int quad;      // 4 if cols_r is whole aligned quads (float4 exchanges), else 1
  int k, mode;
  uint32_t seed, row0;
  float lr;
};

__device__ inline Ctx make_ctx(const Plan& p, int r, int k, int mode,
                               uint32_t seed, uint32_t row0, float lr) {
  Ctx c;
  c.p = p;
  c.r = r;
  c.i0 = split_start(p.vdim, p.C, r);
  c.nrr = split_count(p.vdim, p.C, r);
  c.j0 = split_start(p.hdim, p.C, r);
  c.hcr = split_count(p.hdim, p.C, r);
  c.quad = c.j0 % 4 == 0 && c.hcr % 4 == 0 ? 4 : 1;
  c.k = k;
  c.mode = mode;
  c.seed = seed;
  c.row0 = row0;
  c.lr = lr;
  return c;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float draw(const Ctx& c, uint32_t t, uint32_t stream,
                                      int row, int col) {
  return uniform_at(c.seed, c.row0, t, stream, (uint32_t)row, (uint32_t)col);
}

// The uniforms of columns 4q .. 4q + 3 (one Philox call: its four words).
__device__ __forceinline__ void draw4(const Ctx& c, uint32_t t, uint32_t stream,
                                      int row, int q, float u[4]) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)q, c.row0 + (uint32_t)row, stream, 0u), c.seed, t);
  u[0] = (float)(r.x >> 8) * (1.0f / 16777216.0f);
  u[1] = (float)(r.y >> 8) * (1.0f / 16777216.0f);
  u[2] = (float)(r.z >> 8) * (1.0f / 16777216.0f);
  u[3] = (float)(r.w >> 8) * (1.0f / 16777216.0f);
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a tf32
// value, exact), lo = x - hi (exact in f32; the tensor core reads its top
// 11 bits, so 2^-22 of x is lost).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[m, n] = sum_k A[m, k] B[k, n] over shared memory, A[m, k] at
// cd_smem[a + m * a_m + k * a_k], B[k, n] at cd_smem[b + k * b_k + n * b_n],
// handed to epi.put2 for m < M, n < N. K is a multiple of 8, and A or B is
// zero (the other finite) past the true depth. Each warp takes (16 FM) x
// (8 FN) tiles of C in turn, k in order, on the tensor cores in 3xTF32:
// each operand split into a tf32 high part and a low part, and hi lo +
// lo hi + hi hi summed in f32. a_exact (b_exact) says that A's (B's)
// values are tf32 already (0, 1 or the mask's 0 / 1, binary data): their
// low parts are zero, and the split and the products with them are
// skipped (which changes no bit). Rows and columns past M, N are clamped
// on load and dropped.
template <int FM, int FN, class Epi>
__device__ __forceinline__ void product(int M, int N, int K, int a, int a_m,
                                        int a_k, int b, int b_k, int b_n,
                                        bool a_exact, bool b_exact,
                                        const Epi& epi) {
  if (M <= 0 || N <= 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int tiles_m = (M + 16 * FM - 1) / (16 * FM);
  const int tiles_n = (N + 8 * FN - 1) / (8 * FN);
  for (int wt = warp; wt < tiles_m * tiles_n; wt += kCW) {
    const int m0 = (wt / tiles_n) * 16 * FM, n0 = (wt % tiles_n) * 8 * FN;
    int ar[FM][2], bc[FN];
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      ar[f][0] = a + min(m0 + 16 * f + g, M - 1) * a_m;
      ar[f][1] = a + min(m0 + 16 * f + g + 8, M - 1) * a_m;
    }
#pragma unroll
    for (int f = 0; f < FN; ++f) bc[f] = b + min(n0 + 8 * f + g, N - 1) * b_n;
    // hi hi, and the two cross terms apart: two short chains, not one long.
    float acc[FM][FN][4], cor[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = cor[i][j][v] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = (k0 + tg) * a_k, ka4 = (k0 + tg + 4) * a_k;
      const int kb = (k0 + tg) * b_k, kb4 = (k0 + tg + 4) * b_k;
      uint32_t ahi[FM][4], alo[FM][4], bhi[FN][2], blo[FN][2];
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        const float x[4] = {cd_smem[ar[f][0] + ka], cd_smem[ar[f][1] + ka],
                            cd_smem[ar[f][0] + ka4], cd_smem[ar[f][1] + ka4]};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (a_exact) {
            ahi[f][v] = __float_as_uint(x[v]);
          } else {
            split_tf32(x[v], ahi[f][v], alo[f][v]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        const float y[2] = {cd_smem[bc[f] + kb], cd_smem[bc[f] + kb4]};
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (b_exact) {
            bhi[f][v] = __float_as_uint(y[v]);
          } else {
            split_tf32(y[v], bhi[f][v], blo[f][v]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          if (!a_exact) mma_tf32(cor[i][j], alo[i], bhi[j]);
          if (!b_exact) mma_tf32(cor[i][j], ahi[i], blo[j]);
          mma_tf32(acc[i][j], ahi[i], bhi[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * i + g + 8 * h;
          const int n = n0 + 8 * j + 2 * tg;
          if (m < M && n < N)
            epi.put2(m, n, acc[i][j][2 * h] + cor[i][j][2 * h],
                     acc[i][j][2 * h + 1] + cor[i][j][2 * h + 1], n + 1 < N);
        }
  }
}

// The epilogues take C in pairs of columns n, n + 1 (the second when
// `both`); rows with a leading dimension = 8 (mod 32) take them as one
// 8-byte access without bank conflicts.

// (1) / (3): the block's partial activations, into its own part buffer.
struct Store {
  int o, ld;
  __device__ void put2(int m, int n, float v0, float v1, bool both) const {
    float* at = cd_smem + o + m * ld + n;
    if (both) {
      *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
    } else {
      at[0] = v0;
    }
  }
};

// (e) / (i): dW_r[m, n] += sign * v.
struct Accumulate {
  int dw, ld;
  float sign;
  __device__ void put2(int m, int n, float v0, float v1, bool both) const {
    float* at = cd_smem + dw + m * ld + n;
    if (both) {
      float2 x = *reinterpret_cast<float2*>(at);
      x.x += sign * v0;
      x.y += sign * v1;
      *reinterpret_cast<float2*>(at) = x;
    } else {
      at[0] += sign * v0;
    }
  }
};

// (2): the visible statistic S + b_v into the v_neg tile; draw_visible
// then draws over it in place.
struct Stat {
  int o_vn, ldv, o_bv;
  __device__ void put2(int b, int i, float v0, float v1, bool both) const {
    cd_smem[o_vn + b * ldv + i] = v0 + cd_smem[o_bv + i];
    if (both) cd_smem[o_vn + b * ldv + i + 1] = v1 + cd_smem[o_bv + i + 1];
  }
};

// The visible draw of sweep `sweep` for the tile's rows from the statistic
// in the v_neg tile, times the row mask, in place: an item is a row and an
// aligned quad of visible columns, one Philox call a stream for its four.
__device__ inline void draw_visible(const Ctx& c, uint32_t t, int base, int rows,
                                    int sweep) {
  const Plan& p = c.p;
  if (c.nrr == 0) return;
  const int q0 = c.i0 >> 2, quads = ((c.i0 + c.nrr - 1) >> 2) - q0 + 1;
  for (int e = threadIdx.x; e < rows * quads; e += kCT) {
    const int b = e / quads, q = q0 + (e - b * quads);
    float u1[4], u2[4];
    draw4(c, t, 1 + 3 * sweep, base + b, q, u1);
    if (c.mode != kBernoulli) draw4(c, t, 2 + 3 * sweep, base + b, q, u2);
    const float m = cd_smem[p.o_m + b];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = 4 * q + v - c.i0;
      if (i < 0 || i >= c.nrr) continue;
      float* at = cd_smem + p.o_vn + b * p.ldv + i;
      const float stat = *at;
      float x;
      if (c.mode == kBernoulli) {
        x = u1[v] < sigmoid(stat) ? 1.f : 0.f;
      } else {
        const float z = sqrtf(-2.0f * logf(fmaxf(u1[v], 1e-7f))) *
                        cosf(6.283185307179586f * u2[v]);
        x = stat + (c.mode == kComplex ? 0.7071067811865476f * z : z);
      }
      *at = x * m;
    }
  }
}

// The tile's v_pos rows (rows_r of them) copied into the v_pos buffer with
// cp.async; wait_rows() waits for them.
__device__ inline void copy_rows(const Ctx& c, const float* v, int tile) {
  const Plan& p = c.p;
  const int base = tile * p.bt, rows = min(p.bt, p.batch - base);
  const float* src = v + (size_t)base * p.vdim + c.i0;
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(cd_smem + p.o_vp);
  for (int b = threadIdx.x >> 5; b < rows; b += kCW) {
    for (int i = threadIdx.x & 31; i < c.nrr; i += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       dst + 4u * (uint32_t)(b * p.ldv + i)),
                   "l"(src + (size_t)b * p.vdim + i));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void wait_rows() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Sums of eight lanes (lanes 8q .. 8q + 7 of a warp), in a fixed order:
// every lane of the eight gets the same bits.
__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Per row of the tile: the visible term of F over rows_r, from the v tile
// at offset o, into free-energy slot `slot`; eight lanes a row, each over
// every eighth column.
__device__ inline void visible_terms(const Ctx& c, int o, int rows, int slot) {
  const Plan& p = c.p;
  const int part = threadIdx.x & 7;
  for (int b0 = 0; b0 < rows; b0 += kCT / 8) {
    const int b = b0 + (threadIdx.x >> 3);
    float acc = 0.f;
    if (b < rows) {
      for (int i = part; i < c.nrr; i += 8) {
        const float x = cd_smem[o + b * p.ldv + i], bv = cd_smem[p.o_bv + i];
        if (c.mode == kComplex) {
          const float d = x - bv;
          acc += d * d;
        } else {
          acc += x * bv;
        }
      }
    }
    acc = sum8(acc);
    if (b < rows && part == 0) cd_smem[p.o_fe + 4 * b + slot] = acc;
  }
}

// (b1) / (g1): the owner's activations, an item of `quad` columns at a
// time, four threads (lanes 4e .. 4e + 3) an item: each reads a quarter of
// the C partials from the blocks' buffers (DSMEM, all in flight), sums them
// in rank order, and the four quarter sums are added as (q0 + q1) +
// (q2 + q3); the activation (the sum doubled in complex mode, plus b_h)
// goes to the scratch, rows of hc.
__device__ inline void owner_pull(const Ctx& c, int rows) {
  const Plan& p = c.p;
  cg::cluster_group cl = cg::this_cluster();
  const int w = c.quad, per_row = c.hcr / w, items = rows * per_row;
  const int part = threadIdx.x & 3, share = p.C / 4;  // C is 8 or 16
  for (int e0 = 0; e0 < items; e0 += kCT / 4) {
    const int e = e0 + (threadIdx.x >> 2);
    const bool live = e < items;
    const int b = live ? e / per_row : 0;
    const int jj = live ? (e - b * per_row) * w : 0;
    const int at = p.o_x + b * p.ldp + c.j0 + jj;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      float4 x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < share) {
          const float* src = cl.map_shared_rank(cd_smem + at, part * share + q);
          x[q] = w == 4 ? *reinterpret_cast<const float4*>(src)
                        : make_float4(*src, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < share) {
          sum[0] += x[q].x;
          sum[1] += x[q].y;
          sum[2] += x[q].z;
          sum[3] += x[q].w;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], 1);
      sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], 2);
    }
    if (!live || part != 0) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (v >= w) break;
      cd_smem[p.o_sp + b * p.hc + jj + v] =
          (c.mode == kComplex ? 2.0f * sum[v] : sum[v]) + cd_smem[p.o_bh + jj + v];
    }
  }
}

// (b2) / (g2): from the owner's activations, kind 0: h_pos; 1: a middle
// sweep's h; 2: h_neg, pushed into every block's X (four lanes an item,
// each into a quarter of the blocks); with `slot` >= 0 the softplus terms
// of F a row go to that slot. First the block's own X is cleared where the
// partials lay and X is read as zero: past H and past the tile's rows.
__device__ inline void owner_push(const Ctx& c, uint32_t t, int base, int rows,
                                  int kind, int sweep, int slot) {
  const Plan& p = c.p;
  cg::cluster_group cl = cg::this_cluster();
  for (int b = threadIdx.x >> 5; b < round_up(rows, 8); b += kCW)
    for (int j = (b < rows ? p.hdim : 0) + (threadIdx.x & 31); j < p.hp; j += 32)
      cd_smem[p.o_x + b * p.ldx + j] = 0.f;
  const int w = c.quad, per_row = c.hcr / w, items = rows * per_row;
  const int part = threadIdx.x & 3, share = p.C / 4;
  const uint32_t stream = kind == 0 ? 0u : 3u + 3u * (uint32_t)sweep;
  for (int e = threadIdx.x >> 2; e < items; e += kCT / 4) {
    const int b = e / per_row, jj = (e - b * per_row) * w, j = c.j0 + jj;
    float u[4];
    if (kind != 2) {
      if (w == 4) {
        draw4(c, t, stream, base + b, j >> 2, u);
      } else {
        u[0] = draw(c, t, stream, base + b, j);
      }
    }
    const float m = cd_smem[p.o_m + b];
    float h[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (v >= w) break;
      const float act = cd_smem[p.o_sp + b * p.hc + jj + v];
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
    }
    const int to = p.o_x + b * p.ldx + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < share) {
        float* dst = cl.map_shared_rank(cd_smem + to, part * share + q);
        if (w == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
        } else {
          *dst = h[0];
        }
      }
    }
  }
  if (slot < 0) return;
  float* fr = slot == 3 ? cl.map_shared_rank(cd_smem + p.o_fr, 0) : nullptr;
  for (int b = threadIdx.x; b < rows; b += kCT) {
    float acc = 0.f;
    for (int jj = 0; jj < c.hcr; ++jj) acc += softplus(cd_smem[p.o_sp + b * p.hc + jj]);
    float* fe = cd_smem + p.o_fe + 4 * b;
    fe[slot] = acc;
    if (fr != nullptr) {
      // With F(v_neg)'s softplus terms the block's share of both free
      // energies is known: pushed to block 0, which sums them (score_terms).
      const bool cx = c.mode == kComplex;
      *reinterpret_cast<float2*>(fr + 2 * (c.r * p.bt + b)) =
          make_float2(cx ? fe[0] - fe[1] : -(fe[0] + fe[1]),
                      cx ? fe[2] - fe[3] : -(fe[2] + fe[3]));
    }
  }
}

// (1) / (3): P_r = v[:, rows_r] W_r into the part buffer.
__device__ inline void partials(const Ctx& c, int o_v, int rows, bool v_exact) {
  const Plan& p = c.p;
  product<1, 4>(rows, p.hdim, p.kp, o_v, p.ldv, 1, p.o_w, p.ldw, 1, v_exact,
                false, Store{p.o_x, p.ldp});
}

// dW_r (and the b_h row kp) += sign * v^T X over the tile's rows, from the
// v tile at offset o.
__device__ inline void weight_product(const Ctx& c, int o, int rows, float sign,
                                      bool v_exact, bool x_exact) {
  const Plan& p = c.p;
  product<1, 4>(p.nr + 1, p.hdim, round_up(rows, 8), o, 1, p.ldv, p.o_x, p.ldx,
                1, v_exact, x_exact, Accumulate{p.o_dw, p.ldp, sign});
}

// The b_v sums of rows_r += sign * the tile's column sums of the v tile;
// eight lanes a column, each over every eighth row.
__device__ inline void visible_sums(const Ctx& c, int o, int rows, float sign) {
  const Plan& p = c.p;
  const int part = threadIdx.x & 7;
  for (int i0 = 0; i0 < c.nrr; i0 += kCT / 8) {
    const int i = i0 + (threadIdx.x >> 3);
    float acc = 0.f;
    if (i < c.nrr)
      for (int b = part; b < rows; b += 8) acc += cd_smem[o + b * p.ldv + i];
    acc = sum8(acc);
    if (i < c.nrr && part == 0) cd_smem[p.o_bvs + i] += sign * acc;
  }
}

// Block 0: each row's free energies F(v_pos), F(v_neg), the sums of the
// blocks' shares that they pushed (in rank order), and the tile's score
// sums, sum |dF| m and sum m, added to the step's.
__device__ inline void score_terms(const Ctx& c, int rows) {
  const Plan& p = c.p;
  for (int b = threadIdx.x; b < rows; b += kCT) {
    float fp = 0.f, fn = 0.f;
    for (int q = 0; q < p.C; ++q) {
      const float2 f = *reinterpret_cast<const float2*>(cd_smem + p.o_fr + 2 * (q * p.bt + b));
      fp += f.x;
      fn += f.y;
    }
    cd_smem[p.o_sp + b] = fabsf(fp - fn) * cd_smem[p.o_m + b];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float d = 0.f, n = 0.f;
    for (int b = threadIdx.x; b < rows; b += 32) {
      d += cd_smem[p.o_sp + b];
      n += cd_smem[p.o_m + b];
    }
    d = warp_sum(d);
    n = warp_sum(n);
    if (threadIdx.x == 0) {
      cd_smem[p.o_red] += d;
      cd_smem[p.o_red + 1] += n;
    }
  }
}

#ifdef CD_PROBE
__device__ unsigned long long* g_probe;  // (steps, tiles, C, kMarks) stamps
__device__ int g_probe_steps;
// Probe builds stamp a mark once the whole block has reached it.
#define CD_MARK(t, tile, mark)                                                \
  do {                                                                        \
    __syncthreads();                                                          \
    if (threadIdx.x == 0 && g_probe && (int)(t) < g_probe_steps)              \
      g_probe[(((size_t)(t) * c.p.tiles + (tile)) * c.p.C + c.r) * kMarks +   \
              (mark)] = globaltimer();                                        \
  } while (0)
#else
#define CD_MARK(t, tile, mark) \
  do {                         \
  } while (0)
#endif

// One step on the cluster: v, mask are the step's rows (batch, V) and mask;
// the first tile's rows are already copied in (or in flight). v_next, if
// not null, is the next step's rows: its first tile is copied in during
// this step's last tile. emit(c, t) takes the step's sums at the end.
template <class Emit>
__device__ void cluster_step(const Ctx& c, uint32_t t, const float* v,
                             const float* mask, const float* v_next,
                             const Emit& emit) {
  const Plan& p = c.p;
  cg::cluster_group cl = cg::this_cluster();
  for (int tile = 0; tile < p.tiles; ++tile) {
    const int base = tile * p.bt, rows = min(p.bt, p.batch - base);
    wait_rows();
    bool odd_mask = false;  // a mask value other than 0 and 1
    for (int b = threadIdx.x; b < rows; b += kCT) {
      const float m = mask[base + b];
      cd_smem[p.o_m + b] = m;
      odd_mask |= m != 0.f && m != 1.f;
    }
    bool wide_v = false;  // a v_pos value of this block's rows not in tf32
    for (int b = threadIdx.x >> 5; b < rows; b += kCW)
      for (int i = threadIdx.x & 31; i < c.nrr; i += 32)
        wide_v |= (__float_as_uint(cd_smem[p.o_vp + b * p.ldv + i]) & 0x1fffu) != 0u;
    // Which operands hold tf32 values already: h_pos and the sampled h (0
    // or the mask's value) and the Bernoulli v_neg when the mask is 0 / 1,
    // and v_pos when its values are (binary data, as MNIST's). A block's
    // own v_pos decides its own flag; skipping zero products changes no
    // bit, so the blocks need not agree.
    const bool m01 = !__syncthreads_or(odd_mask);
    const bool vp_exact = !__syncthreads_or(wide_v);
    const bool vn_exact = m01 && c.mode == kBernoulli;
    CD_MARK(t, tile, 0);
    partials(c, p.o_vp, rows, vp_exact);  // (1)
    CD_MARK(t, tile, 1);
    cl.sync();
    CD_MARK(t, tile, 2);
    owner_pull(c, rows);
    cl.sync();  // every block's partials read: X may be written
    owner_push(c, t, base, rows, 0, 0, 1);  // h_pos, softplus of F(v_pos)
    CD_MARK(t, tile, 3);
    visible_terms(c, p.o_vp, rows, 0);
    CD_MARK(t, tile, 4);
    cl.sync();
    CD_MARK(t, tile, 5);
    for (int s = 0; s < c.k; ++s) {
      // (2): v_neg of sweep s from X = h.
      product<2, 2>(rows, c.nrr, p.hp, p.o_x, p.ldx, 1, p.o_w, 1, p.ldw, m01,
                    false, Stat{p.o_vn, p.ldv, p.o_bv});
      __syncthreads();
      CD_MARK(t, tile, 6);
      draw_visible(c, t, base, rows, s);
      __syncthreads();
      CD_MARK(t, tile, 7);
      if (s == 0) {
        visible_terms(c, p.o_vn, rows, 2);
        CD_MARK(t, tile, 8);
        // (e): the positive sums, on v_pos times the mask; then the v_pos
        // buffer is free for the next tile's rows.
        for (int b = threadIdx.x >> 5; b < rows; b += kCW)
          for (int i = threadIdx.x & 31; i < c.nrr; i += 32)
            cd_smem[p.o_vp + b * p.ldv + i] *= cd_smem[p.o_m + b];
        __syncthreads();
        CD_MARK(t, tile, 9);
        weight_product(c, p.o_vp, rows, 1.f, vp_exact && m01, m01);
        CD_MARK(t, tile, 10);
        visible_sums(c, p.o_vp, rows, 1.f);
        __syncthreads();
        if (tile + 1 < p.tiles) {
          copy_rows(c, v, tile + 1);
        } else if (v_next != nullptr) {
          copy_rows(c, v_next, 0);
        }
        CD_MARK(t, tile, 11);
      }
      partials(c, p.o_vn, rows, vn_exact);  // (3)
      CD_MARK(t, tile, 12);
      cl.sync();
      CD_MARK(t, tile, 13);
      owner_pull(c, rows);
      cl.sync();
      owner_push(c, t, base, rows, s == c.k - 1 ? 2 : 1, s, s == 0 ? 3 : -1);
      CD_MARK(t, tile, 14);
      cl.sync();
      CD_MARK(t, tile, 15);
    }
    // (i): the negative sums on X = h_neg; block 0 the score terms.
    weight_product(c, p.o_vn, rows, -1.f, vn_exact, false);
    CD_MARK(t, tile, 16);
    visible_sums(c, p.o_vn, rows, -1.f);
    CD_MARK(t, tile, 17);
    if (c.r == 0) score_terms(c, rows);
    __syncthreads();
    CD_MARK(t, tile, 18);
  }
  emit(c, t);
  CD_MARK(t, p.tiles - 1, 19);
}

// W_r, b_v[rows_r] and b_h[cols_r] from global memory into shared memory;
// every other buffer zeroed, the ones columns set.
__device__ inline void load_params(const Ctx& c, const float* w, const float* bh,
                                   const float* bv) {
  const Plan& p = c.p;
  const int H = p.hdim;
  for (int e = threadIdx.x; e < p.floats; e += kCT) cd_smem[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < c.nrr * H; e += kCT) {
    const int i = e / H, j = e - i * H;
    cd_smem[p.o_w + i * p.ldw + j] = w[(size_t)(c.i0 + i) * H + j];
  }
  for (int i = threadIdx.x; i < c.nrr; i += kCT) cd_smem[p.o_bv + i] = bv[c.i0 + i];
  for (int jj = threadIdx.x; jj < c.hcr; jj += kCT)
    cd_smem[p.o_bh + jj] = bh[c.j0 + jj];
  for (int b = threadIdx.x; b < p.bt8; b += kCT) {
    cd_smem[p.o_vp + b * p.ldv + p.nr] = 1.f;
    cd_smem[p.o_vn + b * p.ldv + p.nr] = 1.f;
  }
  __syncthreads();
}

// Host side.

// The cluster size for a cluster-route launch of `kernel` at this shape:
// `want` if non-zero, else 16 where cudaOccupancyMaxActiveClusters allows
// it and 8 otherwise. Fills *plan and returns 0, or a CUDA error code. Sets
// the kernel's shared-memory and cluster-size attributes.
template <class Kernel>
int choose(Kernel kernel, int batch, int vdim, int hdim, int want, Plan* plan) {
  cudaError_t last = cudaErrorLaunchOutOfResources;
  const int sizes[2] = {kMaxCluster, kMaxCluster / 2};
  for (int C : sizes) {
    if (want != 0 && C != want) continue;
    const Plan p = make_plan(batch, vdim, hdim, C);
    if (p.bt == 0) {
      last = cudaErrorInvalidConfiguration;
      continue;
    }
    const int bytes = p.floats * (int)sizeof(float);
    // The budget, not this plan's bytes: a later launch at another shape
    // needs no new attribute.
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBudget);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kCT);
    cfg.dynamicSmemBytes = bytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters >= 1) {
      *plan = p;
      return 0;
    }
  }
  return (int)last;
}

template <class Kernel, class... Params>
cudaError_t launch(Kernel kernel, const Plan& p, cudaStream_t stream,
                   Params... params) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.C);
  cfg.blockDim = dim3(kCT);
  cfg.dynamicSmemBytes = (size_t)p.floats * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, params...);
  if (e != cudaSuccess) cudaGetLastError();  // not left for the next launch
  return e;
}

}  // namespace cluster
}  // namespace cd
