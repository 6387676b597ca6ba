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

#include "template_tile.cuh"

#ifndef SMPL_API
#define SMPL_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int NS = 15;  // sums per part: raw (9), s_t (3), s_a (3)
constexpr int SEG_MAX = 512;  // vertices per segment at most (PartIndex)

// The warp-per-vertex-group layout of K5: a block of 256 threads owns
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

// The sums of the kernels that walk a segment in tiles of 32 listed vertices
// on template_tile.cuh's layout (K4 and K6): a block of 256 threads owns
// (segment, 128 batch columns), a thread the tile rows 4 tm .. 4 tm + 3
// (tm < 8) and the columns 4 tn .. 4 tn + 3 (tn < 32), and keeps the 15 sums
// of its 4 columns in registers over the segment.
namespace tile_sums {

constexpr int RED_FLOATS = NS * 8 * tmpl::TB;  // [NS][vertex group][TB]

// acc += the sums of the thread's 4 vertices vid (-1: none) at positions
// pos, against the targets tgt (3, Vt, B) (zero past their rows); W: ω
// (fit_weight) multiplies pos in every sum and t in s_t.
template <bool VEC, bool W>
__device__ inline void add(float (&acc)[NS][4], const float (&pos)[3][4][4],
                           const float* __restrict__ tgt, const float* __restrict__ om,
                           const int vid[4], int bc, int B, int Vt, int om_rows, int om_rs,
                           int om_bs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = vid[i];
    float tv[3][4], wk[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* src = tgt + ((size_t)c * Vt + (v >= 0 ? v : 0)) * B + bc;
      const bool row_ok = v >= 0 && v < Vt;
      if (VEC) {
        const float4 v4 = row_ok && bc < B ? __ldg(reinterpret_cast<const float4*>(src))
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        tv[c][0] = v4.x;
        tv[c][1] = v4.y;
        tv[c][2] = v4.z;
        tv[c][3] = v4.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) tv[c][k] = row_ok && bc + k < B ? __ldg(src + k) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wk[k] = W ? (v >= 0 && bc + k < B ? fit_weight(om, v, bc + k, Vt, om_rows, om_rs, om_bs)
                                        : 0.f)
                : 1.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float pw[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) pw[c] = W ? pos[c][i][k] * wk[k] : pos[c][i][k];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[c * 3 + d][k] = fmaf(tv[c][k], pw[d], acc[c * 3 + d][k]);
        acc[9 + c][k] = W ? fmaf(tv[c][k], wk[k], acc[9 + c][k]) : acc[9 + c][k] + tv[c][k];
        acc[12 + c][k] += pw[c];
      }
    }
  }
}

// Sums the 8 vertex groups (tm) of each column in order and writes the
// segment's partial part[seg_id, r, b0 + column]. red: RED_FLOATS of shared
// memory, which no thread may still read (the function starts with a barrier).
__device__ inline void store(const float (&acc)[NS][4], float* red, float* __restrict__ part,
                             int seg_id, int b0, int B, int tm, int tn) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(r * 8 + tm) * tmpl::TB + 4 * tn + k] = acc[r][k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS * tmpl::TB; idx += tmpl::NT) {
    const int r = idx / tmpl::TB, c = idx % tmpl::TB;
    float s = 0.f;
    for (int g = 0; g < 8; ++g) s += red[(r * 8 + g) * tmpl::TB + c];
    if (b0 + c < B) part[((size_t)seg_id * NS + r) * B + b0 + c] = s;
  }
}

}  // namespace tile_sums

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
