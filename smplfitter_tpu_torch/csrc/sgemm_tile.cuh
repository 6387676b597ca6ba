// Shared pieces of the register-tiled f32 GEMMs (posed_template.cu: K7,
// term1.cu: K8).
//
// A block of 256 threads owns a TM x TN tile of C = A B, TM = 64 MI and
// TN = 64 NI, and each thread a 4 MI x 4 NI register micro-tile of it: rows
// 64 g + 4 tm + i (g < MI, i < 4) and columns 64 h + 4 tn + j (h < NI,
// j < 4). A warp covers 4 x 8 threads (tm = 4 (warp / 2) + lane / 8,
// tn = 8 (warp % 2) + lane % 8), so in one k step its lanes read 4 distinct
// float4 of each A group and 8 of each B group: broadcasts, no bank
// conflicts. Both operands are staged k-major in shared memory ([k][row] and
// [k][column]); a k step is MI + NI float4 loads for 16 MI NI FMAs (8 x 16 or
// 16 x 8: 5.3 FMAs per float loaded). All
// arithmetic is f32 FMAs on the CUDA cores (no TF32, no tensor cores). Copies
// into shared memory go through cp.async, 16 bytes where the source rows
// allow it and 4 otherwise, with a source size of 0 (zero fill, nothing read)
// past an operand's edge.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace sgemm {

constexpr int NT = 256;  // threads per block

// The thread's place in the block tile (see above).
struct Lane {
  int tm, tn;
};

__device__ inline Lane lane_tile() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return {4 * (warp / 2) + lane / 8, 8 * (warp % 2) + lane % 8};
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int MI, int NI>
__device__ inline void zero(float (&acc)[4 * MI][4 * NI]) {
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NI; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k As[k * lda + row_i] Bs[k * ldb + col_j] over KT k steps,
// in k order (lda, ldb multiples of 4; both stages 16-byte aligned).
template <int MI, int NI, int KT>
__device__ __forceinline__ void fma_steps(float (&acc)[4 * MI][4 * NI], const float* As,
                                          int lda, const float* Bs, int ldb, Lane t) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    float a[4 * MI], b[4 * NI];
#pragma unroll
    for (int g = 0; g < MI; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(As + k * lda + 64 * g + 4 * t.tm);
      a[4 * g] = v.x;
      a[4 * g + 1] = v.y;
      a[4 * g + 2] = v.z;
      a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < NI; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(Bs + k * ldb + 64 * h + 4 * t.tn);
      b[4 * h] = v.x;
      b[4 * h + 1] = v.y;
      b[4 * h + 2] = v.z;
      b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * MI; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NI; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// C[r0 + row, c0 + col] = acc for the live rows (< M) and columns (< N) of the
// thread's micro-tile; C has row stride ldc. vec: float4 stores (N and ldc
// multiples of 4, C 16-byte aligned), else scalar ones.
template <int MI, int NI>
__device__ inline void store_tile(float* C, size_t ldc, int M, int N, int r0, int c0,
                                  const float (&acc)[4 * MI][4 * NI], Lane t, bool vec) {
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i) {
    const int r = r0 + 64 * (i / 4) + 4 * t.tm + i % 4;
    if (r >= M) continue;
    float* row = C + (size_t)r * ldc;
#pragma unroll
    for (int h = 0; h < NI; ++h) {
      const int c = c0 + 64 * h + 4 * t.tn;
      if (vec) {
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) row[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

}  // namespace sgemm
