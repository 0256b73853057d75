// Data-parallel CD-k training of a restricted Boltzmann machine: one
// rank's step, as two launches with an NCCL all-reduce between them, for
// Hopper (sm_90a).
//
// Replaces ku/pallas/cd_gibbs.py::_make_dp_kernel (ku/pallas/cd_gibbs.py:310).
// It computes what that kernel computes: at every (epoch, step) of the run,
// each rank runs kernel #1's CD-k chain (cd_gibbs.cu) on its own
// batch / world rows of the step; the ranks' statistics are summed; every
// rank applies the same update, W += lr * sum(v_pos^T h_pos - v_neg^T h_neg),
// b_h and b_v likewise, and the step's score is sum |dF| / max(sum mask, 1)
// over the whole batch. ku sums the statistics by an RDMA ring inside its
// kernel, with credit and barrier semaphores; here the sum is
// torch.distributed's all_reduce between two launches (NCCL on the card),
// which gives every rank the same sum, so there is no ring, no credit and
// no barrier in the kernels. A step is:
//   (a) cd_dp_stats: one launch, the CD step over the rank's rows (the
//       Philox counter at the global row, so the draws are the ones a
//       single-device run makes for the same rows), its sums over those
//       rows written to one contiguous f32 buffer of
//       V*H + H + V + 2 floats: the W sums (V x H, W's layout), the b_h
//       sums, the b_v sums, sum |dF| and sum mask. Nothing is added to W.
//   (b) all_reduce(buffer, SUM) over the mesh's group, on the current stream.
//   (c) cd_dp_apply: W += lr * buffer, b_h and b_v likewise, and
//       scores[t] = buffer[sum |dF|] / max(buffer[sum mask], 1).
// Two launches and one all-reduce a step; no host synchronisation.
//
// (a) runs kernel #1's step code on kernel #1's two routes, chosen by the
// shape: on the cluster route (cd_cluster.cuh) one thread-block cluster
// loads W's slices into its shared memory at every launch and runs one
// step; on the global route (cd_grid.cuh) a cooperative grid of a block an
// SM loads its W tiles into shared memory (or reads them from L2 once a
// product where they do not fit) and runs the grid's step, each product
// once over the rank's rows, the partial sums meeting in L2 between grid
// barriers. The sums go to the buffer through an emitter in place of
// kernel #1's update. (c) adds lr * sum in the expression kernel #1 uses
// (sgd), so a run at world size 1 equals kernel #1's run bit for bit on
// either route (an all-reduce over one rank leaves the buffer as it is,
// and both kernels make the same plan at the same shape). At world size
// W > 1 the sums over rows are taken per rank and then over ranks, in
// another order: W moves by ulps.
//
// What bounds a rank's step on an H100: kernel #1's (2k+3)·2·(B/W)·V·H f32
// operations (128.5 MFLOP at k = 1, B 128, V 784, H 128, W 1: 1.9 us at the
// 67 TFLOP/s non-tensor f32 peak), plus the all-reduce's
// 2(W-1)/W x 405,064 bytes of payload (V 784, H 128) on NVLink at 450 GB/s
// each way (0 at W 1; 1.35 us at W 4). As for kernel #1, latency bounds it
// in practice, and each step also pays two launches and the all-reduce's
// host time.
//
// What the design does about it: the step is kernel #1's (statistics and
// apply take about 94 us cold on the cluster route and 75 us on the global
// route at 784 x 128 on an H100); the grid's plan or the cluster size is
// computed once a shape on the host; the payload is one contiguous buffer, so a step is one
// all-reduce; the step is queued on the current stream and the host never
// waits inside the loop. Fusing (c) into the next step's (a), or a CUDA
// graph over the steps, would save host time a step and is left to a later
// change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the entry points have a plain C interface for
//        ctypes.

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

constexpr int kApplyThreads = 256;

// The step's sums written to the statistics buffer.
struct Pack {
  float* buf;
  int vdim, hdim;
  __device__ void weight(int, size_t idx, float d) const { buf[idx] = d; }
  __device__ void hidden(int j, float d) const {
    buf[(size_t)vdim * hdim + j] = d;
  }
  __device__ void visible(int i, float d) const {
    buf[(size_t)vdim * hdim + hdim + i] = d;
  }
  __device__ void score(float d, float c) const {
    float* tail = buf + (size_t)vdim * hdim + hdim + vdim;
    tail[0] = d;
    tail[1] = c;
  }
};

// (a) on the global route: vb, mb are the rank's rows of step t; the
// block's W tiles loaded (resident plans), then cd_grid.cuh's step.
__global__ void __launch_bounds__(cc::kCT, 1)
    cd_dp_stats_kernel(gd::Plan p, const float* w, const float* bh, const float* bv,
                       const float* vb, const float* mb, float* buf, float* scratch,
                       int k, int mode, uint32_t seed, uint32_t t, uint32_t row0) {
  const gd::Ctx c{p, w, bh, bv, scratch, k, mode, seed, row0};
  if (p.resident) gd::load_tiles(c);
  gd::grid_step(c, t, vb, mb, Pack{buf, p.vdim, p.hdim});
}

// (a) on the cluster route: W's slices loaded into the cluster, then
// cd_cluster.cuh's step, its sums written to the buffer in Pack's layout.
struct ClusterPack {
  float* buf;
  __device__ void operator()(const cc::Ctx& c, uint32_t) const {
    const cc::Plan& p = c.p;
    const float* S = cc::cd_smem;
    const int H = p.hdim;
    const size_t vh = (size_t)p.vdim * H;
    __syncthreads();
    for (int i = threadIdx.x >> 5; i < c.nrr; i += cc::kCW)
      for (int j = threadIdx.x & 31; j < H; j += 32)
        buf[(size_t)(c.i0 + i) * H + j] = S[p.o_dw + i * p.ldp + j];
    for (int jj = threadIdx.x; jj < c.hcr; jj += cc::kCT)
      buf[vh + c.j0 + jj] = S[p.o_dw + p.nr * p.ldp + c.j0 + jj];
    for (int i = threadIdx.x; i < c.nrr; i += cc::kCT)
      buf[vh + H + c.i0 + i] = S[p.o_bvs + i];
    if (c.r == 0 && threadIdx.x == 0) {
      buf[vh + H + p.vdim] = S[p.o_red];
      buf[vh + H + p.vdim + 1] = S[p.o_red + 1];
    }
  }
};

__global__ void __launch_bounds__(cc::kCT, 1)
    cd_dp_stats_cluster_kernel(cc::Plan p, const float* w, const float* bh,
                         const float* bv, const float* v, const float* mask,
                         float* buf, int k, int mode, uint32_t seed, uint32_t t,
                         uint32_t row0) {
  cg::cluster_group cluster = cg::this_cluster();
  const cc::Ctx c = cc::make_ctx(p, (int)cluster.block_rank(), k, mode, seed,
                                 row0, 0.f);
  cc::load_params(c, w, bh, bv);
  cc::copy_rows(c, v, 0);
  cc::cluster_step(c, t, v, mask, nullptr, ClusterPack{buf});
  cluster.sync();  // no block leaves while another may read its shared memory
}

// What the last cd_dp_stats launched: as cd_gibbs_last_launch.
int g_last[6] = {-1, 0, 0, 0, 0, 0};

// (c): the summed buffer added into the parameters, and the step's score.
__global__ void __launch_bounds__(kApplyThreads)
    cd_dp_apply_kernel(float* w, float* bh, float* bv, const float* buf,
                       float* scores, int vdim, int hdim, float lr, int t) {
  const size_t vh = (size_t)vdim * hdim, n = vh + hdim + vdim;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float* p = idx < vh ? w + idx : idx < vh + hdim ? bh + (idx - vh)
                                                    : bv + (idx - vh - hdim);
    *p = sgd(*p, lr, buf[idx]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scores[t] = buf[n] / fmaxf(buf[n + 1], 1.f);
}

}  // namespace

extern "C" {

// Blocks of (a)'s cooperative grid for this shape on `device` (one an
// SM), or a negative CUDA error code. Also sets (a)'s shared-memory limit
// and checks that a block of the plan fits an SM, so call it once before
// the first global-route launch at a shape.
int cd_dp_grid(int batch, int vdim, int hdim, int device) {
  gd::Plan p;
  const int err = gd::choose(cd_dp_stats_kernel, batch, vdim, hdim, device, &p);
  return err != 0 ? -err : p.blocks;
}

// Floats of scratch (a) on the global route needs at this shape on
// `device`, or a negative CUDA error code.
long long cd_dp_scratch(int batch, int vdim, int hdim, int device) {
  gd::Plan p;
  const int err = gd::choose(cd_dp_stats_kernel, batch, vdim, hdim, device, &p);
  return err != 0 ? -(long long)err : (long long)p.scratch;
}

// The cluster route's cluster size for this shape (`cluster` if non-zero,
// else 16 where the card allows it and 8 otherwise), its plan in out =
// {C, nr, hc, batch tile, tiles, shared-memory bytes}; sets (a)'s
// attributes, so call it once before the first cluster launch at a shape.
// Returns 0 or a CUDA error code.
int cd_dp_cluster(int batch, int vdim, int hdim, int cluster, int device,
                  int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cc::Plan p;
  const int err = cc::choose(cd_dp_stats_cluster_kernel, batch, vdim, hdim, cluster, &p);
  if (err != 0) return err;
  const int v[6] = {p.C, p.nr, p.hc, p.bt, p.tiles, p.floats * (int)sizeof(float)};
  for (int q = 0; q < 6; ++q) out[q] = v[q];
  return 0;
}

// (a) for step `step` of a run, on `stream`: route 1 the cluster route on
// `blocks` = C blocks from cd_dp_cluster, route 0 the global route on a
// cooperative grid of `blocks` from cd_dp_grid (the plan at that count,
// kept from the last step at this shape), with `scratch` of cd_dp_scratch
// floats. Makes no attribute or occupancy call: cd_dp_cluster or cd_dp_grid
// has made them. Returns the CUDA error of the launch (0 on success); does
// not synchronise.
int cd_dp_stats(const float* v, const float* mask, const float* w,
                const float* bh, const float* bv, float* buf, float* scratch,
                int batch, int vdim, int hdim, int k, int mode, unsigned int seed,
                int step, unsigned int row0, int route, int blocks, int device,
                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  uint32_t t = (uint32_t)step;
  if (route == 1) {
    const cc::Plan p = cc::make_plan(batch, vdim, hdim, blocks);
    if (p.bt == 0) return (int)cudaErrorInvalidConfiguration;
    e = cc::launch(cd_dp_stats_cluster_kernel, p, (cudaStream_t)stream, p, w, bh, bv,
                   v, mask, buf, k, mode, (uint32_t)seed, t, (uint32_t)row0);
    if (e != cudaSuccess) return (int)e;
    const int last[6] = {1, p.C, p.C, p.bt, p.tiles, p.floats * (int)sizeof(float)};
    for (int q = 0; q < 6; ++q) g_last[q] = last[q];
    return (int)cudaGetLastError();
  }
  gd::Plan p = gd::plan_at(batch, vdim, hdim, blocks);
  if (p.tiles == 0) return (int)cudaErrorInvalidConfiguration;
  uint32_t s = (uint32_t)seed, r0 = (uint32_t)row0;
  void* params[] = {&p, &w, &bh, &bv, &v, &mask, &buf, &scratch, &k, &mode, &s, &t, &r0};
  const int bytes = p.floats * (int)sizeof(float);
  e = cudaLaunchCooperativeKernel((const void*)cd_dp_stats_kernel, dim3(p.blocks),
                                  dim3(cc::kCT), params, bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const int last[6] = {0, p.blocks, 0, p.bc, p.tiles, bytes};
  for (int q = 0; q < 6; ++q) g_last[q] = last[q];
  return (int)cudaGetLastError();
}

// What the last cd_dp_stats launched: out = {route (0 global, 1 cluster),
// blocks, cluster size (0 on the global route), batch tile, tiles,
// shared-memory bytes a block}.
void cd_dp_last_launch(int* out) {
  for (int q = 0; q < 6; ++q) out[q] = g_last[q];
}

// (c) for step `step`, on `stream`. Returns the CUDA error of the launch.
int cd_dp_apply(float* w, float* bh, float* bv, const float* buf,
                float* scores, int vdim, int hdim, float lr, int step,
                int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)vdim * hdim + hdim + vdim;
  const int blocks = (int)((n + kApplyThreads - 1) / kApplyThreads);
  cd_dp_apply_kernel<<<blocks, kApplyThreads, 0, (cudaStream_t)stream>>>(
      w, bh, bv, buf, scores, vdim, hdim, lr, step);
  return (int)cudaGetLastError();
}

const char* cd_dp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
