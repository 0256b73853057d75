// One CD-k step's device code, shared by the single-device run
// (cd_gibbs.cu, kernel #1) and the data-parallel step (cd_gibbs_dp.cu,
// kernel #2), so that a data-parallel run at world size 1 computes what the
// single-device run computes, bit for bit.
//
// A step has two phases, separated by a grid-wide barrier:
// - Phase (a), chain_row: with W fixed, each batch row's chain is
//   independent, so a block takes whole rows. It keeps the row's v and h in
//   shared memory, reads W coalesced along H, and writes the row's h_pos,
//   v_neg, h_neg and score term to global scratch.
// - Phase (b), step_sums: the V x H entries of W, in tiles of 8 V-rows x 32
//   columns (one warp each), and the biases are split over every warp of
//   the grid; each entry sums its term over the batch rows from scratch, in
//   row order, and hands the sum to an emitter: kernel #1's adds lr times
//   it into W, kernel #2's writes it to the step's statistics buffer. Block
//   0's first warp sums the score terms and the mask.
// - Random numbers come from Philox4x32-10 in the kernel: key (seed, flat
//   step), counter (col / 4, row0 + row, stream, 0), word col % 4, uniform =
//   top 24 bits * 2^-24, where row0 is the global row of the step's first
//   local row (0 on one device). Streams: 0 = h_pos; for sweep s, 1 + 3s = v
//   (or the first Box-Muller uniform), 2 + 3s = the second Box-Muller
//   uniform, 3 + 3s = h. ku_torch/core/rng.py::philox_uniforms draws the
//   same numbers in torch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;  // V-rows of W per phase-(b) item

constexpr int kBernoulli = 0;
constexpr int kGaussian = 1;
constexpr int kComplex = 2;

// One step's chain: the parameters it reads, its scratch, its shape.
struct Chain {
  const float* w;   // (V, H)
  const float* bh;  // (H,)
  const float* bv;  // (V,)
  float* hpos;      // (batch, H) scratch
  float* vneg;      // (batch, V) scratch
  float* hneg;      // (batch, H) scratch
  float* diff;      // (batch,) scratch
  int batch, vdim, hdim, k, mode;
  uint32_t seed;
  uint32_t row0;    // global row of local row 0, for the Philox counter
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_at(uint32_t seed, uint32_t row0,
                                            uint32_t t, uint32_t stream,
                                            uint32_t row, uint32_t col) {
  const uint4 r = philox4x32_10(make_uint4(col >> 2, row0 + row, stream, 0u),
                                seed, t);
  const uint32_t q = col & 3u;
  const uint32_t bits = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float uniform(const Chain& a, uint32_t t,
                                         uint32_t stream, uint32_t row,
                                         uint32_t col) {
  return uniform_at(a.seed, a.row0, t, stream, row, col);
}

// p + lr * d: the update both kernels apply to a parameter, so that the
// single-device run and a data-parallel run of one rank give the same bits.
__device__ __forceinline__ float sgd(float p, float lr, float d) {
  return fmaf(lr, d, p);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return x > 30.0f ? x : log1pf(expf(fminf(x, 30.0f)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block; every thread gets the same result.
__device__ inline float block_sum(float x, float* s_red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) total += s_red[q];
  __syncthreads();
  return total;
}

// s_act[j] = c * (s_vis . W[:, j]) + b_h[j], c = 2 in complex mode.
// Warp q sums a slice of V for columns lane, lane + 32, ...; the slices
// meet in s_part.
__device__ inline void hidden_act(const Chain& a, const float* s_vis,
                                  float* s_act, float* s_part) {
  const int V = a.vdim, H = a.hdim;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (V + kWarps - 1) / kWarps;
  const int i0 = warp * chunk, i1 = min(V, i0 + chunk);
  for (int j = lane; j < H; j += 32) {
    const float* wj = a.w + j;
    float acc = 0.f;
#pragma unroll 8
    for (int i = i0; i < i1; ++i) acc = fmaf(s_vis[i], wj[(size_t)i * H], acc);
    s_part[warp * H + j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) dot += s_part[q * H + j];
    s_act[j] = (a.mode == kComplex ? 2.0f * dot : dot) + a.bh[j];
  }
  __syncthreads();
}

// F(v) from v and its hidden activation, both in shared memory.
__device__ inline float free_energy(const Chain& a, const float* s_vis,
                                    const float* s_act, float* s_red) {
  float sp = 0.f, vis = 0.f;
  for (int j = threadIdx.x; j < a.hdim; j += kThreads) sp += softplus(s_act[j]);
  for (int i = threadIdx.x; i < a.vdim; i += kThreads) {
    if (a.mode == kComplex) {
      const float d = s_vis[i] - a.bv[i];
      vis += d * d;
    } else {
      vis += s_vis[i] * a.bv[i];
    }
  }
  sp = block_sum(sp, s_red);
  vis = block_sum(vis, s_red);
  return a.mode == kComplex ? vis - sp : -(vis + sp);
}

// s_vn = a draw of v given s_h for batch row `row`, Gibbs sweep `sweep`,
// times the row mask m. A warp takes 32 visible units at a time: it sums
// each unit's dot product across its lanes, and lane q then draws unit q.
__device__ inline void visible_draw(const Chain& a, uint32_t t, int row,
                                    int sweep, float m, const float* s_h,
                                    float* s_vn) {
  const int V = a.vdim, H = a.hdim;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = warp * 32; base < V; base += kThreads) {
    const int n = min(32, V - base);
    float mine = 0.f;
    for (int q = 0; q < n; ++q) {
      const float* wi = a.w + (size_t)(base + q) * H;
      float part = 0.f;
      for (int j = lane; j < H; j += 32) part = fmaf(s_h[j], wi[j], part);
      part = warp_sum(part);
      if (lane == q) mine = part;
    }
    const int i = base + lane;
    if (i < V) {
      const float stat = mine + a.bv[i];
      float x;
      if (a.mode == kBernoulli) {
        x = uniform(a, t, 1 + 3 * sweep, row, i) < sigmoid(stat) ? 1.f : 0.f;
      } else {
        const float u1 = fmaxf(uniform(a, t, 1 + 3 * sweep, row, i), 1e-7f);
        const float u2 = uniform(a, t, 2 + 3 * sweep, row, i);
        const float z = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
        x = stat + (a.mode == kComplex ? 0.7071067811865476f * z : z);
      }
      s_vn[i] = x * m;
    }
  }
  __syncthreads();
}

// Phase (a) for one batch row: the whole chain with W fixed.
__device__ inline void chain_row(const Chain& a, uint32_t t, const float* vb,
                                 const float* mb, int row, float* smem) {
  const int V = a.vdim, H = a.hdim;
  float* s_v = smem;                  // V: v_pos
  float* s_vn = s_v + V;              // V: the chain's v
  float* s_h = s_vn + V;              // H: the chain's h sample
  float* s_act = s_h + H;             // H: hidden activation
  float* s_part = s_act + H;          // kWarps * H: partial dot products
  float* s_red = s_part + kWarps * H; // kWarps: block sums
  const float m = mb[row];

  for (int i = threadIdx.x; i < V; i += kThreads) s_v[i] = vb[(size_t)row * V + i];
  __syncthreads();
  hidden_act(a, s_v, s_act, s_part);
  const float fe_pos = free_energy(a, s_v, s_act, s_red);
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float act = s_act[j];
    const float p = a.mode == kGaussian ? fmaxf(act, 0.f) : sigmoid(act);
    const float h = uniform(a, t, 0, row, j) < p ? m : 0.f;
    s_h[j] = h;
    a.hpos[(size_t)row * H + j] = h;
  }
  __syncthreads();

  float fe_neg = 0.f;
  for (int s = 0; s < a.k; ++s) {
    visible_draw(a, t, row, s, m, s_h, s_vn);
    hidden_act(a, s_vn, s_act, s_part);
    if (s == 0) fe_neg = free_energy(a, s_vn, s_act, s_red);
    const bool last = s == a.k - 1;
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float act = s_act[j];
      const float hn = sigmoid(act) * m;
      if (last) {
        a.hneg[(size_t)row * H + j] = hn;
      } else {
        const float p = a.mode == kGaussian ? fmaxf(act, 0.f) * m : hn;
        s_h[j] = uniform(a, t, 3 + 3 * s, row, j) < p ? 1.f : 0.f;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < V; i += kThreads) a.vneg[(size_t)row * V + i] = s_vn[i];
  if (threadIdx.x == 0) a.diff[row] = fabsf(fe_pos - fe_neg) * m;
  __syncthreads();  // shared memory is reused by the block's next row
}

// Phase (b): the step's sums over the batch rows in scratch, in row order,
// handed to `emit`: emit.weight(i * H + j, sum of v_pos h_pos - v_neg h_neg),
// emit.visible(i, ...), emit.hidden(j, ...), and once
// emit.score(sum of score terms, sum of the mask).
template <class Emit>
__device__ inline void step_sums(const Chain& a, const float* vb,
                                 const float* mb, const Emit& emit) {
  const int V = a.vdim, H = a.hdim, B = a.batch;
  const int lane = threadIdx.x & 31;
  const int hchunks = (H + 31) / 32;
  const int items = ((V + kTileRows - 1) / kTileRows) * hchunks;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
       item += gridDim.x * kWarps) {
    const int tile = item / hchunks, jc = item % hchunks;
    const int i0 = tile * kTileRows, j = jc * 32 + lane;
    const bool jok = j < H;
    // Positive and negative sums kept apart, as in v_pos^T h_pos - v_neg^T h_neg.
    float wp[kTileRows], wn[kTileRows], bvp[kTileRows], bvn[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) wp[r] = wn[r] = bvp[r] = bvn[r] = 0.f;
    float bhp = 0.f, bhn = 0.f;
    for (int b = 0; b < B; ++b) {
      const float m = mb[b];
      const float hp = jok ? a.hpos[(size_t)b * H + j] : 0.f;
      const float hn = jok ? a.hneg[(size_t)b * H + j] : 0.f;
      bhp += hp;
      bhn += hn;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        if (i0 + r < V) {
          const float vp = vb[(size_t)b * V + i0 + r] * m;
          const float vn = a.vneg[(size_t)b * V + i0 + r];
          wp[r] = fmaf(vp, hp, wp[r]);
          wn[r] = fmaf(vn, hn, wn[r]);
          bvp[r] += vp;
          bvn[r] += vn;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int i = i0 + r;
      if (i < V && jok) emit.weight((size_t)i * H + j, wp[r] - wn[r]);
      if (i < V && jc == 0 && lane == r) emit.visible(i, bvp[r] - bvn[r]);
    }
    if (tile == 0 && jok) emit.hidden(j, bhp - bhn);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float d = 0.f, c = 0.f;
    for (int b = lane; b < B; b += 32) {
      d += a.diff[b];
      c += mb[b];
    }
    d = warp_sum(d);
    c = warp_sum(c);
    if (lane == 0) emit.score(d, c);
  }
}

inline size_t shared_bytes(int vdim, int hdim) {
  return sizeof(float) *
         (2 * (size_t)vdim + (2 + kWarps) * (size_t)hdim + kWarps);
}

// Blocks of a cooperative grid for a step kernel at this shape on `device`,
// or a negative CUDA error code: enough for one block a row and one warp a
// phase-(b) item, no more than can be co-resident.
template <class Kernel>
int cooperative_grid(Kernel kernel, int batch, int vdim, int hdim, int device) {
  const size_t smem = shared_bytes(vdim, hdim);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int items = ((vdim + kTileRows - 1) / kTileRows) * ((hdim + 31) / 32);
  const int want = max(batch, (items + kWarps - 1) / kWarps);
  return min(want, sms * per_sm);
}

}  // namespace cd
