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
// - A step's two phases, the row-parallel chain and the sums over rows, and
//   the in-kernel Philox draws are cd_gibbs_chain.cuh's, shared with the
//   data-parallel step (cd_gibbs_dp.cu); here the sums go straight into W,
//   b_h and b_v, W += lr * sum.
//
// Every block reaches every grid.sync(), including blocks that own no row:
// a block that returned early would deadlock the grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the entry point has a plain C interface for ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cd_gibbs_chain.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cd;

struct Args {
  Chain c;            // the parameters (updated in place) and the scratch
  const float* v;     // (steps * batch, V) data, zero rows past the end
  const float* mask;  // (steps * batch,) 0/1 row mask
  float* w;           // (V, H), the same memory as c.w
  float* bh;          // (H,)
  float* bv;          // (V,)
  float* scores;      // (epochs * steps,)
  int steps, epochs;
  float lr;
};

// Phase (b)'s sums added into the parameters: W += lr * sum, and the step's
// score.
struct Update {
  float* w;
  float* bh;
  float* bv;
  float* scores;
  float lr;
  uint32_t t;
  __device__ void weight(size_t idx, float d) const { w[idx] += lr * d; }
  __device__ void visible(int i, float d) const { bv[i] += lr * d; }
  __device__ void hidden(int j, float d) const { bh[j] += lr * d; }
  __device__ void score(float d, float c) const { scores[t] = d / fmaxf(c, 1.f); }
};

__global__ void __launch_bounds__(kThreads) cd_gibbs_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int total = a.steps * a.epochs;
  const int batch = a.c.batch, vdim = a.c.vdim;
  for (int t = 0; t < total; ++t) {
    const int s = t % a.steps;
    const float* vb = a.v + (size_t)s * batch * vdim;
    const float* mb = a.mask + (size_t)s * batch;
    for (int row = blockIdx.x; row < batch; row += gridDim.x)
      chain_row(a.c, (uint32_t)t, vb, mb, row, smem);
    grid.sync();
    step_sums(a.c, vb, mb, Update{a.w, a.bh, a.bv, a.scores, a.lr, (uint32_t)t});
    grid.sync();
  }
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid for this shape on `device`, or a negative
// CUDA error code. The grid is no larger than the co-resident block count.
int cd_gibbs_grid(int batch, int vdim, int hdim, int device) {
  return cooperative_grid(cd_gibbs_kernel, batch, vdim, hdim, device);
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
  const Chain c{w,    bh,   bv,   hpos, vneg, hneg, diff, batch,
                vdim, hdim, k,    mode, seed, 0u};
  Args a{c, v, mask, w, bh, bv, scores, steps, epochs, lr};
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
