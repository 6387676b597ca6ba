// The ordered sum of per-split partials that the split kernels end with
// (term1.cu: K8, dfeat_gemm.cu, the backward kernels K10-K14): no atomics,
// so two runs give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace {

// out[idx] = sum over splits of part[sp * n + idx], in split order.
__global__ void split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int n_splits, size_t n) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part[(size_t)sp * n + idx];
    out[idx] = s;
  }
}

inline cudaError_t launch_split_sum(const float* part, float* out, int n_splits, size_t n,
                                    cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  split_sum_kernel<<<blocks, threads, 0, stream>>>(part, out, n_splits, n);
  return cudaGetLastError();
}

}  // namespace
