// The front of the backward LBS kernels K10 (lbs_points_bwd.cu) and K14
// (recon_lbs_part_sums_bwd.cu): the pieces a block uses on one tile of listed
// vertices, and the two GEMMs around it.
//
// A kernel computes, for a vertex cotangent g of the points (K10: given; K14:
// dpos, from the part cotangents), the joint cotangents
//     dpj[a*4+c, j, b] = sum_v w_vj g_a(v, b) h_c(v, b)   (h_3 = 1)    (12, J, B)
// and the feature cotangent dfeat = sum_c consts_c^T (Rbar^T g)_c, where h is
// the posed template and Rbar the blended rotation. It runs in three steps:
// 1. h (3, V_pad, B) by the port's K7 GEMM (posed_template.cu) into a
//    workspace;
// 2. the front kernel walks the tiles of a vertex list (a cover's segments
//    or a part index's 32-vertex tiles, each with the active joints of its
//    segment: every joint with a nonzero weight on one of its vertices; the
//    joints left out weigh exactly 0 there). A block owns a run of tiles and
//    128 batch columns; a thread 4 vertices x 4 columns (K2's layout:
//    lane = 4 tm + column group, so a warp holds the tile's 32 vertices of 16
//    columns). Per tile it blends Rbar^T g over the segment's joints
//    (tmpl::blend_project) and writes it to the second workspace U
//    (3, V_pad, B) at the tile's vertices (the rows no tile holds are
//    cleared: they add nothing, as in the dense sum), and sums dpj over the tile's
//    vertices for the segment's joints only: in registers over the thread's
//    4 vertices, then a warp reduce-scatter over its 8 vertex groups
//    (tmpl::reduce_scatter8), after which one owner lane per (row, column)
//    adds the sum to its run's partial in device memory (the owner of an
//    entry is the same lane for every tile, so no barrier orders the adds);
//    the runs' partials are added in run order by split_sum_kernel;
// 3. dfeat by the split-K GEMM of dfeat_gemm.cu over U, K = 3 V_pad.
// No atomics: two runs give the same bits.
#pragma once

#include "template_tile.cuh"

// posed_template.cu (K7): feat (F, B), consts (>= 3, Vp, F) -> out (3, Vp, B).
extern "C" int posed_template_launch(const float* feat, const float* consts, float* out, int F,
                                     int B, int Vp, cudaStream_t stream);
// dfeat_gemm.cu: consts (>= 3, Vp, F), U (3, Vp, B) -> out (F, B).
extern "C" int dfeat_gemm_launch(const float* consts, const float* U, float* part, float* out,
                                 int F, int B, int Vp, int n_splits, cudaStream_t stream);

namespace front {

using tmpl::NT;
using tmpl::TB;
using tmpl::TV;

// A tile of the list: its first list row, its rows (<= TV) and its segment.
struct Tile {
  int beg, n, seg;
};

__device__ __forceinline__ Tile tile_at(const int* __restrict__ tile_offset,
                                        const int* __restrict__ tile_seg, int t) {
  const int beg = __ldg(tile_offset + t);
  return {beg, __ldg(tile_offset + t + 1) - beg, tile_seg ? __ldg(tile_seg + t) : t};
}

// The vertices of the thread's tile rows 4 tm .. 4 tm + 3 (-1 past the tile).
__device__ __forceinline__ void tile_vertices(int vid[4], const int* __restrict__ verts,
                                              Tile tl, int tm) {
#pragma unroll
  for (int i = 0; i < 4; ++i) vid[i] = 4 * tm + i < tl.n ? __ldg(verts + tl.beg + 4 * tm + i) : -1;
}

// x[c][i][k] = src[c, vid_i, bc + k] of a (3, Vx, B) array, zero for a row
// with no vertex and past the batch edge.
template <bool VEC>
__device__ __forceinline__ void load3(float (&x)[3][4][4], const float* __restrict__ src, int Vx,
                                      const int vid[4], int B, int bc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (vid[i] >= 0) {
        tmpl::load4<VEC>(x[c][i], src + ((size_t)c * Vx + vid[i]) * B + bc, bc, B);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[c][i][k] = 0.f;
      }
    }
}

// dst[c, vid_i, bc + k] = x[c][i][k] of a (3, Vx, B) array (nothing for a row
// with no vertex).
template <bool VEC>
__device__ __forceinline__ void store3(float* __restrict__ dst, int Vx,
                                       const float (&x)[3][4][4], const int vid[4], int B,
                                       int bc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (vid[i] < 0) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      tmpl::store4<VEC>(dst + ((size_t)c * Vx + vid[i]) * B + bc, x[c][i], bc, B);
  }
}

// The lane's own dpj entries: rows a*4 + 2q + tm / 4 (a < 3, q < 2) of every
// joint, column bc + tm % 4.
__device__ inline void zero_dpj(float* __restrict__ part, int J, int B, int bc, int tm) {
  const int col = bc + (tm & 3);
  if (col >= B) return;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int x = a * 4 + 2 * q + (tm >> 2);
      for (int j = 0; j < J; ++j) part[((size_t)x * J + j) * B + col] = 0.f;
    }
}

// part[a*4+c, j, col] += sum over the tile's vertices of w[v, j] g_a(v) h_c(v)
// (h_3 = 1) for the segment's active joints jl[0 .. nA): per joint and a,
// the 4 x 4 sums of the thread's vertices in registers, then two
// reduce-scatters of (row pair, 4 columns); the lane of vertex group tm owns
// rows a*4 + 2q + tm / 4 and column bc + tm % 4.
__device__ inline void add_dpj(float* __restrict__ part, const float (&g)[3][4][4],
                               const float (&h)[3][4][4], const float* __restrict__ w,
                               const int* __restrict__ jl, int nA, int J, int B, int bc,
                               const int vid[4], int tm) {
  const int col = bc + (tm & 3);
  for (int jj = 0; jj < nA; ++jj) {
    const int j = __ldg(jl + jj);
    float wv[4];
    tmpl::joint_weights(wv, w, vid, J, j);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float wg[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) wg[i][k] = wv[i] * g[a][i][k];
      float s[4][4];  // [c][column]
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) t = fmaf(wg[i][k], h[c][i][k], t);
          s[c][k] = t;
        }
        s[3][k] = ((wg[0][k] + wg[1][k]) + wg[2][k]) + wg[3][k];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float x[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[k] = s[2 * q][k];
          x[4 + k] = s[2 * q + 1][k];
        }
        const float r = tmpl::reduce_scatter8(x, tm);
        if (col < B) part[((size_t)(a * 4 + 2 * q + (tm >> 2)) * J + j) * B + col] += r;
      }
    }
  }
}

}  // namespace front
