// Shared pieces of the per-part-sum kernels (recon_part_sums.cu: K4,
// part_sums.cu: K5, recon_lbs_part_sums.cu: K6).
//
// Each kernel reduces, per body part p and batch column, the 15 sums
//     raw[c*3+d] = sum t_c a_d,  s_t[c] = sum t_c,  s_a[d] = sum a_d
// over the part's vertices, for a target t and a reference a. The body-part
// membership is one-hot over vertices, so the host lists each part's vertices
// and cuts the lists into segments of at most 512 (PartIndex in
// ops/lbs_kernels.py). A block reduces one segment for a tile of batch columns
// and writes one partial (n_seg, 15, B); part_sum_kernel then sums each part's
// segment partials in segment order. No float atomics: runs repeat bit for bit.
#pragma once

#include <cuda_runtime.h>

#ifndef SMPL_API
#define SMPL_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int NS = 15;  // sums per part: raw (9), s_t (3), s_a (3)

// The warp-per-vertex-group layout of K4 and K5: a block of 256 threads owns
// (segment, 32 batch columns), one column per lane; each of the 8 warps walks
// every 8th group of 4 vertices with the 15 sums in registers.
namespace seg {
constexpr int NT = 256;
constexpr int TB4 = 32;       // batch columns per block (one per lane)
constexpr int NW = NT / TB4;  // warps per block
constexpr int VQ = 4;         // vertices per warp step
}  // namespace seg

// acc += the 15 sums of VQ vertices of one lane (t and a zero for a vertex
// outside the segment).
__device__ inline void add_part_sums(float acc[NS], const float t[3][seg::VQ],
                                     const float a[3][seg::VQ]) {
#pragma unroll
  for (int q = 0; q < seg::VQ; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[c * 3 + d] = fmaf(t[c][q], a[d][q], acc[c * 3 + d]);
      acc[9 + c] += t[c][q];
      acc[12 + c] += a[c][q];
    }
  }
}

// The fit-weighted form: a already carries the vertex's weight ω (so raw and
// s_a are weighted through it), and s_t adds t ω.
__device__ inline void add_part_sums_w(float acc[NS], const float t[3][seg::VQ],
                                       const float a[3][seg::VQ], const float om[seg::VQ]) {
#pragma unroll
  for (int q = 0; q < seg::VQ; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[c * 3 + d] = fmaf(t[c][q], a[d][q], acc[c * 3 + d]);
      acc[9 + c] = fmaf(t[c][q], om[q], acc[9 + c]);
      acc[12 + c] += a[c][q];
    }
  }
}

// A fit weight: ω[v * rs + b * bs] for a vertex below both the target's rows
// Vt and the weights' rows, else 0. The static column (V_pad, 1) is read with
// rs = 1, bs = 0; per-call weights (Vt, B) with rs = B, bs = 1.
__device__ inline float fit_weight(const float* __restrict__ om, int v, int b, int Vt,
                                   int om_rows, int rs, int bs) {
  return (v < Vt && v < om_rows) ? om[(size_t)v * rs + (size_t)b * bs] : 0.f;
}

// Combines the warps' sums in warp order and writes the segment's partial
// part[seg, r, b0 + lane]. red_s holds NW * NS * TB4 floats.
__device__ inline void store_warp_partials(const float acc[NS], float* red_s,
                                           float* __restrict__ part, int seg_id, int b0,
                                           int B) {
  const int lane = threadIdx.x % seg::TB4, wid = threadIdx.x / seg::TB4;
#pragma unroll
  for (int r = 0; r < NS; ++r) red_s[(wid * NS + r) * seg::TB4 + lane] = acc[r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS * seg::TB4; idx += seg::NT) {
    const int r = idx / seg::TB4, c = idx % seg::TB4;
    float s = 0.f;
    for (int g = 0; g < seg::NW; ++g) s += red_s[(g * NS + r) * seg::TB4 + c];
    if (b0 + c < B) part[((size_t)seg_id * NS + r) * B + b0 + c] = s;
  }
}

// Sums each part's segment partials in segment order into raw / s_t / s_a.
__global__ void part_sum_kernel(const float* __restrict__ part,
                                const int* __restrict__ part_seg, float* __restrict__ raw,
                                float* __restrict__ st, float* __restrict__ sa, int J, int B) {
  const size_t n = (size_t)J * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx / B);
    const int b = (int)(idx % B);
    const int s0 = part_seg[j], s1 = part_seg[j + 1];
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      float s = 0.f;
      for (int sg = s0; sg < s1; ++sg) s += part[((size_t)sg * NS + r) * B + b];
      if (r < 9) raw[((size_t)r * J + j) * B + b] = s;
      else if (r < 12) st[((size_t)(r - 9) * J + j) * B + b] = s;
      else sa[((size_t)(r - 12) * J + j) * B + b] = s;
    }
  }
}

inline cudaError_t launch_part_sum(const float* part, const int* part_seg, float* raw, float* st,
                                   float* sa, int J, int B, cudaStream_t stream) {
  const size_t n = (size_t)J * B;
  const int threads = 256;
  part_sum_kernel<<<(int)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, part_seg, raw, st, sa, J, B);
  return cudaGetLastError();
}

}  // namespace
