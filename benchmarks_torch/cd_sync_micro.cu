// Microbenchmark of what a CD cluster step (ku_torch/csrc/cd_cluster.cuh)
// waits on, on one H100: one cluster of C blocks loops `iters` times over
//   mode 0: __syncthreads();
//   mode 1: a cluster barrier (cluster.sync(): barrier.cluster arrive and
//           wait);
//   mode 2: a read-modify-write of 3,136 floats of shared memory (a 64-row
//           tile of 49 visible rows) and __syncthreads();
//   mode 3: one 16-byte load from another block's shared memory (DSMEM),
//           each depending on the last: a round trip;
//   mode 4: one 16-byte store into another block's shared memory and
//           __syncthreads();
// and prints ns and SM cycles an iteration (%globaltimer and clock64 of
// block 0). Built and run by benchmarks_torch/cd_cluster_micro.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
namespace cg = cooperative_groups;
__device__ __forceinline__ uint64_t gt() { uint64_t t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
extern __shared__ float sm[];
// mode 0: __syncthreads loop; 1: cluster.sync loop; 2: smem rmw + syncthreads; 3: DSMEM float4 load round trips
__global__ void k(int mode, int iters, unsigned long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) sm[i] = i;
  cl.sync();
  uint64_t t0 = gt(); long long c0 = clock64();
  float acc = 0;
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) { __syncthreads(); }
    else if (mode == 1) { cl.sync(); }
    else if (mode == 2) { for (int i = threadIdx.x; i < 3136; i += blockDim.x) sm[i] *= 1.0001f; __syncthreads(); }
    else if (mode == 3) { const float4* p = (const float4*)cl.map_shared_rank(sm + 4 * (threadIdx.x & 255), (blockIdx.x + 1 + it) % cl.num_blocks()); float4 x = *p; acc += x.x; __syncwarp(); }
    else if (mode == 4) { float* p = cl.map_shared_rank(sm + 4096 + 4 * (threadIdx.x & 255), (blockIdx.x + 1 + it) % cl.num_blocks()); *(float4*)p = make_float4(acc, 1, 2, 3); __syncthreads(); }
  }
  uint64_t t1 = gt(); long long c1 = clock64();
  cl.sync();
  if (threadIdx.x == 0) { out[blockIdx.x * 3] = t1 - t0; out[blockIdx.x * 3 + 1] = c1 - c0; out[blockIdx.x * 3 + 2] = (unsigned long long)acc; }
}
int main() {
  unsigned long long* d; cudaMalloc(&d, 64 * 3 * 8);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int C : {16, 8, 2}) for (int threads : {256, 512}) for (int mode = 0; mode < 5; ++mode) {
    int iters = 2000;
    cudaLaunchConfig_t cfg = {}; cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeClusterDimension; a[0].val.clusterDim.x = C; a[0].val.clusterDim.y = 1; a[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C); cfg.blockDim = dim3(threads); cfg.dynamicSmemBytes = 100000; cfg.attrs = a; cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, k, mode, iters, d); cudaDeviceSynchronize();
    unsigned long long h[3]; cudaMemcpy(h, d, 24, cudaMemcpyDeviceToHost);
    printf("C %d threads %d mode %d: err %d, %.1f ns/iter, %.1f cycles/iter, clock %.3f GHz\n", C, threads, mode, (int)e, (double)h[0] / iters, (double)h[1] / iters, (double)h[1] / h[0]);
  }
  return 0;
}
