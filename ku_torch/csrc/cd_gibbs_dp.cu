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
//   (a) cd_dp_stats: one cooperative launch. The chain over the rank's rows
//       (the Philox counter at the global row, so the draws are the ones a
//       single-device run makes for the same rows), grid.sync(), then the
//       sums over those rows written to one contiguous f32 buffer of
//       V*H + H + V + 2 floats: the W sums (V x H, W's layout), the b_h
//       sums, the b_v sums, sum |dF| and sum mask. Nothing is added to W.
//   (b) all_reduce(buffer, SUM) over the mesh's group, on the current stream.
//   (c) cd_dp_apply: W += lr * buffer, b_h and b_v likewise, and
//       scores[t] = buffer[sum |dF|] / max(buffer[sum mask], 1).
// Two launches and one all-reduce a step; no host synchronisation.
//
// Both phases of (a) are cd_gibbs_chain.cuh's, the code kernel #1 runs, and
// (c) adds lr * sum in the expression kernel #1 uses, so a run at world size
// 1 equals kernel #1's run bit for bit (an all-reduce over one rank leaves
// the buffer as it is). At world size W > 1 the sums over rows are taken per
// rank and then over ranks, in another order: W moves by ulps.
//
// What bounds a rank's step on an H100: kernel #1's (2k+3)·2·(B/W)·V·H f32
// operations (128.5 MFLOP at k = 1, B 128, V 784, H 128, W 1: 1.9 us at the
// 67 TFLOP/s non-tensor f32 peak), plus the all-reduce's
// 2(W-1)/W x 405,064 bytes of payload (V 784, H 128) on NVLink at 450 GB/s
// each way (0 at W 1; 1.35 us at W 4). As for kernel #1, latency bounds it
// in practice: a step is a chain of dependent passes over W in L2, too
// small to fill the card, and here each step also pays two launches and the
// all-reduce's own launch.
//
// What the design does about it: the chain keeps kernel #1's design (one
// block a row, W read from L2, the rows' scratch in global memory, sums in
// row order by one warp per 8 x 32 tile of W), so the step costs about what
// kernel #1's step costs plus the launches; the grid is computed once a run
// on the host; the payload is one contiguous buffer, so a step is one
// all-reduce; the step is queued on the current stream and the host never
// waits inside the loop. Fusing (c) into the next step's (a) would save a
// launch a step and is left to a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the entry points have a plain C interface for
//        ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_gibbs_chain.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cd;

constexpr int kApplyThreads = 256;

// Phase (b)'s sums written to the step's statistics buffer.
struct Pack {
  float* buf;
  int vdim, hdim;
  __device__ void weight(size_t idx, float d) const { buf[idx] = d; }
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

// (a): vb, mb are the rank's rows of step t; every block reaches the
// grid.sync(), including blocks that own no row.
__global__ void __launch_bounds__(kThreads)
    cd_dp_stats_kernel(Chain c, const float* vb, const float* mb, float* buf,
                       uint32_t t) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int row = blockIdx.x; row < c.batch; row += gridDim.x)
    chain_row(c, t, vb, mb, row, smem);
  grid.sync();
  step_sums(c, vb, mb, Pack{buf, c.vdim, c.hdim});
}

// (c): the summed buffer added into the parameters, and the step's score.
__global__ void __launch_bounds__(kApplyThreads)
    cd_dp_apply_kernel(float* w, float* bh, float* bv, const float* buf,
                       float* scores, int vdim, int hdim, float lr, int t) {
  const size_t vh = (size_t)vdim * hdim, n = vh + hdim + vdim;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float* p = idx < vh ? w + idx : idx < vh + hdim ? bh + (idx - vh)
                                                    : bv + (idx - vh - hdim);
    *p += lr * buf[idx];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scores[t] = buf[n] / fmaxf(buf[n + 1], 1.f);
}

}  // namespace

extern "C" {

// Blocks of (a)'s cooperative grid for this shape on `device`, or a
// negative CUDA error code. Also sets (a)'s shared-memory limit, so call it
// once before the first launch at a shape.
int cd_dp_grid(int batch, int vdim, int hdim, int device) {
  return cooperative_grid(cd_dp_stats_kernel, batch, vdim, hdim, device);
}

// (a) for step `step` of a run, on `stream`, with `grid` from cd_dp_grid.
// Returns the CUDA error of the launch (0 on success); does not synchronise.
int cd_dp_stats(const float* v, const float* mask, const float* w,
                const float* bh, const float* bv, float* buf, float* hpos,
                float* vneg, float* hneg, float* diff, int batch, int vdim,
                int hdim, int k, int mode, unsigned int seed, int step,
                unsigned int row0, int grid, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Chain c{w,    bh,   bv,   hpos, vneg, hneg, diff, batch,
          vdim, hdim, k,    mode, seed, row0};
  uint32_t t = (uint32_t)step;
  void* params[] = {&c, &v, &mask, &buf, &t};
  e = cudaLaunchCooperativeKernel((const void*)cd_dp_stats_kernel, dim3(grid),
                                  dim3(kThreads), params,
                                  shared_bytes(vdim, hdim),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
