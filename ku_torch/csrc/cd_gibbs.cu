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
// step (128.5 MFLOP at k=1, B=128, V=784, H=128), 0.26 us at the card's
// 495 TFLOP/s TF32 tensor-core peak (the products run in 3xTF32); the data
// is read once per epoch, far below the memory bound. But the steps form a
// chain (each needs the parameters the last one wrote) and one step is too
// small to fill the card, so the kernel is bound by latency: barriers and
// round trips to shared memory or L2 between a step's phases.
//
// Two routes, chosen by the shape (ku_torch/kernels/cd_gibbs.py
// route_for), one launch for the whole run on either, each step's products
// run once over all the batch rows on the tensor cores in 3xTF32 (f32-exact)
// on both:
// - The cluster route (cd_cluster.cuh), for every shape whose slices fit a
//   block's shared memory at 16 blocks: one thread-block cluster holds W
//   split by visible rows in shared memory for the whole run, as ku's
//   kernel holds it in VMEM, exchanges partial activations and hidden units
//   through distributed shared memory between cluster barriers, and adds
//   the sums into W in shared memory; W, b_h, b_v go back to global memory
//   at the end. At the RBM's shape a step takes about 70 us on an H100
//   (the global route about 40 us).
// - The global route (cd_grid.cuh) for a larger W: one persistent
//   cooperative grid, a block an SM, W cut into tiles that the blocks hold
//   in shared memory for the whole run (or read from L2 once a product
//   where they do not fit); each product's partial sums meet in L2 between
//   six grid.sync() a step, and each tile's owner adds the step's sums into
//   its tile.
// Both share their step code with the data-parallel statistics kernel
// (cd_gibbs_dp.cu), whose apply adds the sums in the same expression
// (sgd), so that a data-parallel run at world size 1 equals this run bit
// for bit on either route.
//
// Every block reaches every barrier, including blocks that own no row,
// column or batch row: a block that returned early would deadlock.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the entry point has a plain C interface for ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_gibbs_chain.cuh"
#include "cd_cluster.cuh"
#include "cd_grid.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cd;
namespace cc = cd::cluster;
namespace gd = cd::grid;

// ---------------------------------------------------------------------------
// The global route: one cooperative grid, cd_grid.cuh's step.
// ---------------------------------------------------------------------------

struct Args {
  gd::Plan p;
  const float* v;     // (steps * batch, V) data, zero rows past the end
  const float* mask;  // (steps * batch,) 0/1 row mask
  float* w;           // (V, H), updated in place (or at the end: resident tiles)
  float* bh;          // (H,)
  float* bv;          // (V,)
  float* scores;      // (epochs * steps,)
  float* scratch;     // (p.scratch,)
  int steps, epochs, k, mode;
  float lr;
  uint32_t seed;
};

// The step's sums added into the parameters: W += lr * sum in the tile in
// shared memory (resident plans) or in global memory, the biases in global
// memory, and the step's score.
struct Update {
  float* w;
  float* bh;
  float* bv;
  float* scores;
  float lr;
  uint32_t t;
  __device__ void weight(int s, size_t g, float d) const {
    if (s >= 0) {
      cc::cd_smem[s] = sgd(cc::cd_smem[s], lr, d);
    } else {
      w[g] = sgd(w[g], lr, d);
    }
  }
  __device__ void visible(int i, float d) const { bv[i] = sgd(bv[i], lr, d); }
  __device__ void hidden(int j, float d) const { bh[j] = sgd(bh[j], lr, d); }
  __device__ void score(float d, float c) const { scores[t] = d / fmaxf(c, 1.f); }
};

__global__ void __launch_bounds__(cc::kCT, 1) cd_gibbs_kernel(Args a) {
  const gd::Plan& p = a.p;
  const gd::Ctx c{p, a.w, a.bh, a.bv, a.scratch, a.k, a.mode, a.seed, 0u};
  if (p.resident) gd::load_tiles(c);
  const int total = a.steps * a.epochs;
  for (int t = 0; t < total; ++t) {
    const int s = t % a.steps;
    gd::grid_step(c, (uint32_t)t, a.v + (size_t)s * p.batch * p.vdim,
                  a.mask + (size_t)s * p.batch,
                  Update{a.w, a.bh, a.bv, a.scores, a.lr, (uint32_t)t});
  }
  if (!p.resident) return;
  for (int n = 0; n < p.per && gd::own(n) < p.tiles; ++n) {
    const gd::Tile T = gd::tile_at(p, gd::own(n));
    const int o = gd::w_at(p, n);
    for (int e = threadIdx.x; e < T.rv * T.rh; e += cc::kCT) {
      const int i = e / T.rh, j = e - i * T.rh;
      a.w[(size_t)(T.i0 + i) * p.hdim + T.j0 + j] = cc::cd_smem[o + i * p.ldw + j];
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster route: one cluster for the whole run, cd_cluster.cuh's step.
// ---------------------------------------------------------------------------

struct ClusterArgs {
  const float* v;     // (steps * batch, V)
  const float* mask;  // (steps * batch,)
  float* w;           // (V, H), read at the start, written at the end
  float* bh;
  float* bv;
  float* scores;      // (epochs * steps,)
  int steps, epochs, k, mode;
  float lr;
  uint32_t seed;
};

// The step's sums added into the parameters held in shared memory, with the
// expression kernel #2's apply uses (sgd), and the step's score; the sums
// are zeroed for the next step.
struct ClusterUpdate {
  float* scores;
  __device__ void operator()(const cc::Ctx& c, uint32_t t) const {
    const cc::Plan& p = c.p;
    float* S = cc::cd_smem;
    const int H = p.hdim;
    __syncthreads();
    for (int i = threadIdx.x >> 5; i < c.nrr; i += cc::kCW) {
      for (int j = threadIdx.x & 31; j < H; j += 32) {
        float* w = S + p.o_w + i * p.ldw + j;
        float* d = S + p.o_dw + i * p.ldp + j;
        *w = sgd(*w, c.lr, *d);
        *d = 0.f;
      }
    }
    for (int jj = threadIdx.x; jj < c.hcr; jj += cc::kCT)
      S[p.o_bh + jj] = sgd(S[p.o_bh + jj], c.lr, S[p.o_dw + p.nr * p.ldp + c.j0 + jj]);
    for (int i = threadIdx.x; i < c.nrr; i += cc::kCT) {
      S[p.o_bv + i] = sgd(S[p.o_bv + i], c.lr, S[p.o_bvs + i]);
      S[p.o_bvs + i] = 0.f;
    }
    if (c.r == 0 && threadIdx.x == 0) {
      scores[t] = S[p.o_red] / fmaxf(S[p.o_red + 1], 1.f);
      S[p.o_red] = S[p.o_red + 1] = 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += cc::kCT) S[p.o_dw + p.nr * p.ldp + j] = 0.f;
    __syncthreads();
  }
};

__global__ void __launch_bounds__(cc::kCT, 1)
    cd_gibbs_cluster_kernel(ClusterArgs a, cc::Plan p) {
  cg::cluster_group cluster = cg::this_cluster();
  const cc::Ctx c = cc::make_ctx(p, (int)cluster.block_rank(), a.k, a.mode,
                                 a.seed, 0u, a.lr);
  cc::load_params(c, a.w, a.bh, a.bv);
  cc::copy_rows(c, a.v, 0);
  const int total = a.steps * a.epochs;
  const size_t step_floats = (size_t)p.batch * p.vdim;
  for (int t = 0; t < total; ++t) {
    const int s = t % a.steps;
    const float* next =
        t + 1 < total ? a.v + (size_t)((t + 1) % a.steps) * step_floats : nullptr;
    cc::cluster_step(c, (uint32_t)t, a.v + (size_t)s * step_floats,
                     a.mask + (size_t)s * p.batch, next, ClusterUpdate{a.scores});
  }
  float* S = cc::cd_smem;
  for (int i = threadIdx.x >> 5; i < c.nrr; i += cc::kCW)
    for (int j = threadIdx.x & 31; j < p.hdim; j += 32)
      a.w[(size_t)(c.i0 + i) * p.hdim + j] = S[p.o_w + i * p.ldw + j];
  for (int i = threadIdx.x; i < c.nrr; i += cc::kCT) a.bv[c.i0 + i] = S[p.o_bv + i];
  for (int jj = threadIdx.x; jj < c.hcr; jj += cc::kCT) a.bh[c.j0 + jj] = S[p.o_bh + jj];
  cluster.sync();  // no block leaves while another may read its shared memory
}

// What the last cd_gibbs_train launched: route (0 global, 1 cluster),
// blocks, cluster size, batch tile, tiles, shared-memory bytes a block.
int g_last[6] = {-1, 0, 0, 0, 0, 0};

}  // namespace


extern "C" {

// Blocks of the global route's cooperative grid for this shape on
// `device` (one an SM), or a negative CUDA error code.
int cd_gibbs_grid(int batch, int vdim, int hdim, int device) {
  gd::Plan p;
  const int err = gd::choose(cd_gibbs_kernel, batch, vdim, hdim, device, &p);
  return err != 0 ? -err : p.blocks;
}

// Floats of scratch a global-route launch at this shape on `device` needs
// (cd_gibbs_train's `scratch`), or a negative CUDA error code.
long long cd_gibbs_scratch(int batch, int vdim, int hdim, int device) {
  gd::Plan p;
  const int err = gd::choose(cd_gibbs_kernel, batch, vdim, hdim, device, &p);
  return err != 0 ? -(long long)err : (long long)p.scratch;
}

// The cluster route's plan at cluster size C: out = {C, nr, hc, batch
// tile, tiles, shared-memory bytes}; bytes 0 when no tile fits.
void cd_gibbs_plan(int batch, int vdim, int hdim, int C, int* out) {
  const cc::Plan p = cc::make_plan(batch, vdim, hdim, C);
  const int v[6] = {p.C, p.nr, p.hc, p.bt, p.tiles,
                    p.bt ? p.floats * (int)sizeof(float) : 0};
  for (int q = 0; q < 6; ++q) out[q] = v[q];
}

// The whole run in one launch on `stream`: route 1 the cluster route (one
// cluster of `cluster` blocks, 0 = 16 where the card allows it, else 8),
// route 0 the global route (a cooperative grid, with `scratch` of
// cd_gibbs_scratch floats). Returns the CUDA error of the launch (0 on
// success); does not synchronise.
int cd_gibbs_train(const float* v, const float* mask, float* w, float* bh,
                   float* bv, float* scores, float* scratch, int steps,
                   int epochs, int batch, int vdim, int hdim, int k, int mode,
                   float lr, unsigned int seed, int route, int cluster,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (route == 1) {
    cc::Plan p;
    const int err = cc::choose(cd_gibbs_cluster_kernel, batch, vdim, hdim, cluster, &p);
    if (err != 0) return err;
    ClusterArgs a{v, mask, w, bh, bv, scores, steps, epochs, k, mode, lr, seed};
    e = cc::launch(cd_gibbs_cluster_kernel, p, (cudaStream_t)stream, a, p);
    if (e != cudaSuccess) return (int)e;
    const int last[6] = {1, p.C, p.C, p.bt, p.tiles, p.floats * (int)sizeof(float)};
    for (int q = 0; q < 6; ++q) g_last[q] = last[q];
    return (int)cudaGetLastError();
  }
  gd::Plan p;
  const int err = gd::choose(cd_gibbs_kernel, batch, vdim, hdim, device, &p);
  if (err != 0) return err;
  Args a{p, v, mask, w, bh, bv, scores, scratch, steps, epochs, k, mode, lr, seed};
  void* params[] = {&a};
  const int bytes = p.floats * (int)sizeof(float);
  e = cudaLaunchCooperativeKernel((const void*)cd_gibbs_kernel, dim3(p.blocks),
                                  dim3(cc::kCT), params, bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const int last[6] = {0, p.blocks, 0, p.bc, p.tiles, bytes};
  for (int q = 0; q < 6; ++q) g_last[q] = last[q];
  return (int)cudaGetLastError();
}

// What the last cd_gibbs_train launched: out = {route (0 global, 1
// cluster), blocks, cluster size (0 on the global route), batch tile
// (the global route's chunk of rows), tiles (of the batch on the cluster
// route, of W on the global route), shared-memory bytes a block}.
void cd_gibbs_last_launch(int* out) {
  for (int q = 0; q < 6; ++q) out[q] = g_last[q];
}

#ifdef CD_PROBE
// Probe builds only: every launch after this records timestamps
// (%globaltimer) into `stamps` for its first `steps` steps: the cluster
// route (steps, tiles, C, cc::kMarks), the global route (steps, blocks,
// gd::kMarks). A null `stamps` stops it.
int cd_gibbs_probe(void* stamps, int steps) {
  cudaError_t e = cudaMemcpyToSymbol(cc::g_probe, &stamps, sizeof(stamps));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(cc::g_probe_steps, &steps, sizeof(steps));
}
#endif

const char* cd_gibbs_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
