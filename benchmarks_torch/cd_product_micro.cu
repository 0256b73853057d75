// Microbenchmark of one product of a CD cluster step
// (ku_torch/csrc/cd_cluster.cuh) on one SM of an H100: the (1) product at
// the RBM's shape, C[64 x 128] = A[64 x 56] B[56 x 128] from shared memory
// (one block, 1,000 calls back to back), as
//   mode 0: 3xTF32 on mma.sync m16n8k8 (the kernel's product);
//   mode 1: one tf32 pass (hi hi only: the floor of the tensor-core path);
//   mode 2: 3xTF32 with 32 x 32 warp tiles;
//   mode 3: f32 FFMA over 4 x 8 register tiles;
//   mode 4: mode 0 and a __syncthreads() a call;
// at 256 and 512 threads, and prints ns and SM cycles a call. Built and run
// by benchmarks_torch/cd_cluster_micro.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ uint64_t gt() { uint64_t t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
extern __shared__ __align__(16) float cd_smem[];
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int FM, int FN, int NW, int SPLIT>
__device__ __forceinline__ void product(int M, int N, int K, int a, int a_m, int a_k, int b, int b_k, int b_n, int o, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int tiles_m = (M + 16 * FM - 1) / (16 * FM), tiles_n = (N + 8 * FN - 1) / (8 * FN);
  for (int wt = warp; wt < tiles_m * tiles_n; wt += NW) {
    const int m0 = (wt / tiles_n) * 16 * FM, n0 = (wt % tiles_n) * 8 * FN;
    int ar[FM][2], bc[FN];
#pragma unroll
    for (int f = 0; f < FM; ++f) { ar[f][0] = a + min(m0 + 16 * f + g, M - 1) * a_m; ar[f][1] = a + min(m0 + 16 * f + g + 8, M - 1) * a_m; }
#pragma unroll
    for (int f = 0; f < FN; ++f) bc[f] = b + min(n0 + 8 * f + g, N - 1) * b_n;
    float acc[FM][FN][4], cor[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = cor[i][j][v] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = (k0 + tg) * a_k, ka4 = (k0 + tg + 4) * a_k, kb = (k0 + tg) * b_k, kb4 = (k0 + tg + 4) * b_k;
      uint32_t ahi[FM][4], alo[FM][4], bhi[FN][2], blo[FN][2];
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        split_tf32(cd_smem[ar[f][0] + ka], ahi[f][0], alo[f][0]); split_tf32(cd_smem[ar[f][1] + ka], ahi[f][1], alo[f][1]);
        split_tf32(cd_smem[ar[f][0] + ka4], ahi[f][2], alo[f][2]); split_tf32(cd_smem[ar[f][1] + ka4], ahi[f][3], alo[f][3]);
      }
#pragma unroll
      for (int f = 0; f < FN; ++f) { split_tf32(cd_smem[bc[f] + kb], bhi[f][0], blo[f][0]); split_tf32(cd_smem[bc[f] + kb4], bhi[f][1], blo[f][1]); }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          if (SPLIT) mma_tf32(cor[i][j], alo[i], bhi[j]);
          mma_tf32(acc[i][j], ahi[i], bhi[j]);
          if (SPLIT) mma_tf32(cor[i][j], ahi[i], blo[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * i + g + 8 * h, n = n0 + 8 * j + 2 * tg;
          if (m < M && n < N) *reinterpret_cast<float2*>(cd_smem + o + m * ld + n) = make_float2(acc[i][j][2*h] + cor[i][j][2*h], acc[i][j][2*h+1] + cor[i][j][2*h+1]);
        }
  }
}
// FFMA reference: 4x8 register tile
template <int NT>
__device__ __forceinline__ void ffma(int M, int N, int K, int a, int a_m, int a_k, int b, int b_k, int b_n, int o, int ld) {
  constexpr int TX = 16, TY = NT / 16, TM = 64 / TY, TN = 8;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN] = {};
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int q = 0; q < TM; ++q) av[q] = cd_smem[a + (ty + q * TY) * a_m + k * a_k];
#pragma unroll
    for (int p = 0; p < TN; ++p) bv[p] = cd_smem[b + k * b_k + (tx + p * TX) * b_n];
#pragma unroll
    for (int q = 0; q < TM; ++q)
#pragma unroll
      for (int p = 0; p < TN; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
  }
#pragma unroll
  for (int q = 0; q < TM; ++q)
#pragma unroll
    for (int p = 0; p < TN; ++p) cd_smem[o + (ty + q * TY) * ld + tx + p * TX] = acc[q][p];
}
template <int NT, int MODE>
__global__ void __launch_bounds__(NT, 1) k(int iters, unsigned long long* out) {
  for (int i = threadIdx.x; i < 50000; i += NT) cd_smem[i] = (i % 7) * 0.1f;
  __syncthreads();
  // Vp 64 x 60 at 0; W 56 x 132 at 4096; part 64 x 136 at 16384
  uint64_t t0 = gt(); long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (MODE == 0) product<1, 4, NT / 32, 1>(64, 128, 56, 0, 60, 1, 4096, 132, 1, 16384, 136);
    if (MODE == 1) product<1, 4, NT / 32, 0>(64, 128, 56, 0, 60, 1, 4096, 132, 1, 16384, 136);
    if (MODE == 2) product<2, 4, NT / 32, 1>(64, 128, 56, 0, 60, 1, 4096, 132, 1, 16384, 136);
    if (MODE == 3) ffma<NT>(64, 128, 56, 0, 60, 1, 4096, 132, 1, 16384, 136);
    if (MODE == 4) product<1, 4, NT / 32, 1>(64, 128, 56, 0, 60, 1, 4096, 132, 1, 16384, 136);  // + sync
    if (MODE == 4) __syncthreads();
  }
  uint64_t t1 = gt(); long long c1 = clock64();
  if (threadIdx.x == 0) { out[0] = t1 - t0; out[1] = c1 - c0; }
}
template <int NT, int MODE> void run(unsigned long long* d) {
  cudaFuncSetAttribute(k<NT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000);
  int iters = 1000;
  k<NT, MODE><<<1, NT, 200000>>>(iters, d); cudaDeviceSynchronize();
  unsigned long long h[2]; cudaMemcpy(h, d, 16, cudaMemcpyDeviceToHost);
  printf("threads %d mode %d: %.1f ns/call, %.0f cycles/call (err %d)\n", NT, MODE, (double)h[0] / iters, (double)h[1] / iters, (int)cudaGetLastError());
}
int main() {
  unsigned long long* d; cudaMalloc(&d, 64);
  run<256, 0>(d); run<256, 1>(d); run<256, 2>(d); run<256, 3>(d); run<256, 4>(d);
  run<512, 0>(d); run<512, 1>(d); run<512, 2>(d); run<512, 3>(d); run<512, 4>(d);
  return 0;
}
