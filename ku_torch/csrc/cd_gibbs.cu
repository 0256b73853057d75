// CD-k training of a restricted Boltzmann machine, one launch for a whole
// multi-epoch run, for Hopper (sm_90a).
//
// Replaces ku/pallas/cd_gibbs.py::_make_kernel. It computes the same
// function as _cd_pallas_impl there: for each batch step, in (epoch, step)
// order,
//   h_pos ~ Bernoulli(p), p = sigmoid(vW + b_h) (relu in Gaussian mode, the
//           activation doubled in complex mode);
//   k Gibbs sweeps: v ~ Bernoulli(sigmoid(hW^T + b_v)) or Gaussian (Box-Muller,
//           u1 clamped at 1e-7; sigma = 1, or sqrt(1/2) in complex mode),
//           h_neg = sigmoid of the activation in every mode;
//   score = sum |F(v_pos) - F(v_1)| / max(sum mask, 1) on the pre-update
//           parameters;
//   W += lr (v_pos^T h_pos - v_neg^T h_neg), b_h and b_v likewise (raw sums),
// the parameters carrying from step to step. Masked rows (the ragged last
// batch) contribute nothing. Bounds checks replace the TPU's 128-padding.
//
// What bounds it on an H100: the f32 work is (2k+3)·2·B·V·H operations per
// step (128.5 MFLOP at k=1, B=128, V=784, H=128), 1.9 us at the card's
// 67 TFLOP/s non-tensor f32 peak; the data is read once per epoch, far
// below the memory bound. But the steps form a chain (each needs the
// parameters the last one wrote) and one step is too small to fill the
// card, so this kernel is bound by latency: with one 256-thread block per
// SM, most loads from L2 wait on the one before. On an H100 SXM (700 W) a
// step takes about 123 us, 1.6 % of the operation bound (PERF.md).
//
// What the design does about it:
// - One persistent cooperative launch for the whole run, so no step pays a
//   launch; cooperative_groups grid.sync() separates the two phases of a step.
// - W stays in global memory and is served from L2: f32 W at 784x128 is
//   392 KiB, more than one block's 227 KB of shared memory, and a small part
//   of the 50 MB L2.
// - Phase (a), row-parallel chain. With W fixed, each batch row's chain is
//   independent, so a block takes whole rows. It keeps the row's v and h in
//   shared memory, reads W coalesced along H, and writes the row's h_pos,
//   v_neg, h_neg and score term to global scratch.
// - Phase (b), update. The V x H entries of W, in tiles of 8 V-rows x 32
//   columns (one warp each), and the biases are split over every warp of the
//   grid; each entry sums its term over the batch rows from scratch. Block 0
//   writes the step's score.
// - Random numbers come from Philox4x32-10 in the kernel: key (seed, flat
//   step), counter (col / 4, row, stream, 0), word col % 4, uniform = top 24
//   bits * 2^-24. Streams: 0 = h_pos; for sweep s, 1 + 3s = v (or the first
//   Box-Muller uniform), 2 + 3s = the second Box-Muller uniform, 3 + 3s = h.
//   ku_torch/core/rng.py::philox_uniforms draws the same numbers in torch.
//
// Every block reaches every grid.sync(), including blocks that own no row:
// a block that returned early would deadlock the grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the entry point has a plain C interface for ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;  // V-rows of W per update item

constexpr int kBernoulli = 0;
constexpr int kGaussian = 1;
constexpr int kComplex = 2;

struct Args {
  const float* v;     // (steps * batch, V) data, zero rows past the end
  const float* mask;  // (steps * batch,) 0/1 row mask
  float* w;           // (V, H), updated in place
  float* bh;          // (H,)
  float* bv;          // (V,)
  float* scores;      // (epochs * steps,)
  float* hpos;        // (batch, H) scratch
  float* vneg;        // (batch, V) scratch
  float* hneg;        // (batch, H) scratch
  float* diff;        // (batch,) scratch
  int steps, epochs, batch, vdim, hdim, k, mode;
  float lr;
  uint32_t seed;
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

__device__ __forceinline__ float uniform(const Args& a, uint32_t t,
                                         uint32_t stream, uint32_t row,
                                         uint32_t col) {
  const uint4 r = philox4x32_10(make_uint4(col >> 2, row, stream, 0u), a.seed, t);
  const uint32_t q = col & 3u;
  const uint32_t bits = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
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
__device__ float block_sum(float x, float* s_red) {
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
__device__ void hidden_act(const Args& a, const float* s_vis, float* s_act,
                           float* s_part) {
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
__device__ float free_energy(const Args& a, const float* s_vis,
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
__device__ void visible_draw(const Args& a, uint32_t t, int row, int sweep,
                             float m, const float* s_h, float* s_vn) {
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
__device__ void chain_row(const Args& a, uint32_t t, const float* vb,
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

// Phase (b): W, b_h and b_v from the scratch rows, and the step's score.
__device__ void update(const Args& a, uint32_t t, const float* vb,
                       const float* mb) {
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
      if (i < V && jok) a.w[(size_t)i * H + j] += a.lr * (wp[r] - wn[r]);
      if (i < V && jc == 0 && lane == r) a.bv[i] += a.lr * (bvp[r] - bvn[r]);
    }
    if (tile == 0 && jok) a.bh[j] += a.lr * (bhp - bhn);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float d = 0.f, c = 0.f;
    for (int b = lane; b < B; b += 32) {
      d += a.diff[b];
      c += mb[b];
    }
    d = warp_sum(d);
    c = warp_sum(c);
    if (lane == 0) a.scores[t] = d / fmaxf(c, 1.f);
  }
}

__global__ void __launch_bounds__(kThreads) cd_gibbs_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int total = a.steps * a.epochs;
  for (int t = 0; t < total; ++t) {
    const int s = t % a.steps;
    const float* vb = a.v + (size_t)s * a.batch * a.vdim;
    const float* mb = a.mask + (size_t)s * a.batch;
    for (int row = blockIdx.x; row < a.batch; row += gridDim.x)
      chain_row(a, (uint32_t)t, vb, mb, row, smem);
    grid.sync();
    update(a, (uint32_t)t, vb, mb);
    grid.sync();
  }
}

size_t shared_bytes(int vdim, int hdim) {
  return sizeof(float) *
         (2 * (size_t)vdim + (2 + kWarps) * (size_t)hdim + kWarps);
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid for this shape on `device`, or a negative
// CUDA error code. The grid is no larger than the co-resident block count.
int cd_gibbs_grid(int batch, int vdim, int hdim, int device) {
  const size_t smem = shared_bytes(vdim, hdim);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(cd_gibbs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cd_gibbs_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int items = ((vdim + kTileRows - 1) / kTileRows) * ((hdim + 31) / 32);
  const int want = max(batch, (items + kWarps - 1) / kWarps);
  return min(want, sms * per_sm);
}

// The whole run in one cooperative launch on `stream`. Returns the CUDA
// error of the launch (0 on success); does not synchronise.
int cd_gibbs_train(const float* v, const float* mask, float* w, float* bh,
                   float* bv, float* scores, float* hpos, float* vneg,
                   float* hneg, float* diff, int steps, int epochs, int batch,
                   int vdim, int hdim, int k, int mode, float lr,
                   unsigned int seed, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int grid = cd_gibbs_grid(batch, vdim, hdim, device);
  if (grid < 0) return -grid;
  Args a{v,     mask,  w,    bh,   bv,    scores, hpos, vneg, hneg, diff,
         steps, epochs, batch, vdim, hdim, k,      mode, lr,   seed};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)cd_gibbs_kernel, dim3(grid),
                                  dim3(kThreads), params,
                                  shared_bytes(vdim, hdim),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* cd_gibbs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
