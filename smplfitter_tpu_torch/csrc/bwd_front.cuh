// The front of the backward LBS kernels K10 (lbs_points_bwd.cu), K11 and K12
// (rhs_bwd.cu), K13 (recon_bwd.cu) and K14 (recon_lbs_part_sums_bwd.cu): the
// pieces a block uses on one tile of listed vertices, and the two GEMMs
// around it (K10, K11 and K14; K12 and K13 read a cached template).
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
// The part index's fronts (K13, K14) take dpos and dtgt from the 15
// cotangent rows of the tile's one part (part_dpos, store_dtgt) and zero the
// rows that no part holds (zero_unused). K11 and K12 sum two rank-1 fields
// per joint, -db h and G b, in the same reduce-scatters (add_dpj2).
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

// part[a*4+c, j, col] += sum over the tile's vertices of w[v, j] (g_a h_c
// [+ g2_a h2_c]) (h_3 = 1, h2_3 = 0) for one joint j and row group a: the
// 4 x 4 sums of the thread's vertices in registers (per vertex i, an FMA of
// w g_a with h_c, then with TWO one of w g2_a with h2_c), then two
// reduce-scatters of (row pair, 4 columns); the lane of vertex group tm owns
// rows a*4 + 2q + tm / 4 and column col = bc + tm % 4.
template <bool TWO>
__device__ __forceinline__ void add_joint_dpj(float* __restrict__ part, const float wv[4],
                                              const float (&ga)[4][4],
                                              const float (&h)[3][4][4],
                                              const float (&g2a)[4][4],
                                              const float (&h2)[3][4][4], int a, int j, int J,
                                              int B, int col, int tm) {
  float wg[4][4], wg2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wg[i][k] = wv[i] * ga[i][k];
      wg2[i][k] = TWO ? wv[i] * g2a[i][k] : 0.f;
    }
  float s[4][4];  // [c][column]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t = fmaf(wg[i][k], h[c][i][k], t);
        if (TWO) t = fmaf(wg2[i][k], h2[c][i][k], t);
      }
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

// part[a*4+c, j, col] += sum over the tile's vertices of w[v, j] g_a(v) h_c(v)
// (h_3 = 1) for the segment's active joints jl[0 .. nA), joint by joint.
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
    for (int a = 0; a < 3; ++a)
      add_joint_dpj<false>(part, wv, g[a], h, g[a], h, a, j, J, B, col, tm);
  }
}

// The thread's stage of three per-vertex fields (K11/K12's -db, b and the
// template h): float4 (the 4 columns) of field f, row a, vertex i at
// stage[((f * 3 + a) * 4 + i) * NT + thread]. Each thread reads only what it
// wrote, so no barrier orders them.
constexpr int STAGE_FLOAT4 = 3 * 3 * 4 * NT;

__device__ __forceinline__ void stage_field(float4* stage, int f, const float (&x)[3][4][4]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stage[((f * 3 + a) * 4 + i) * NT + threadIdx.x] =
          make_float4(x[a][i][0], x[a][i][1], x[a][i][2], x[a][i][3]);
}

__device__ __forceinline__ void staged_row(float (&x)[4][4], const float4* stage, int f, int a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = stage[((f * 3 + a) * 4 + i) * NT + threadIdx.x];
    x[i][0] = v.x;
    x[i][1] = v.y;
    x[i][2] = v.z;
    x[i][3] = v.w;
  }
}

__device__ __forceinline__ void staged_field(float (&x)[3][4][4], const float4* stage, int f) {
#pragma unroll
  for (int a = 0; a < 3; ++a) staged_row(x[a], stage, f, a);
}

// add_dpj for two rank-1 fields in the same reduce-scatters: part[a*4+c, j,
// col] += sum over the tile's vertices of w[v, j] (g_a h_c + g2_a h2_c)
// (h_3 = 1, h2_3 = 0), g and g2 the staged fields 0 and 1, one row group a
// at a time (the joints' weights are read again per a, from L1), so that of
// the four fields only h and h2 stay in registers.
__device__ inline void add_dpj2(float* __restrict__ part, const float4* stage,
                                const float (&h)[3][4][4], const float (&h2)[3][4][4],
                                const float* __restrict__ w, const int* __restrict__ jl, int nA,
                                int J, int B, int bc, const int vid[4], int tm) {
  const int col = bc + (tm & 3);
#pragma unroll 1
  for (int a = 0; a < 3; ++a) {
    float ga[4][4], g2a[4][4];
    staged_row(ga, stage, 0, a);
    staged_row(g2a, stage, 1, a);
    for (int jj = 0; jj < nA; ++jj) {
      const int j = __ldg(jl + jj);
      float wv[4];
      tmpl::joint_weights(wv, w, vid, J, j);
      add_joint_dpj<true>(part, wv, ga, h, g2a, h2, a, j, J, B, col, tm);
    }
  }
}

// The part cotangents' pull on the positions of the thread's vertices, all
// of one part p (its rows of gsa (3, J, B) and graw (9, J, B) read once per
// tile and column): dpos_d = ω (gsa[d, p] + sum_c graw[c*3+d, p] t_c), with
// the targets t (3, Vt, B) zero past their rows.
template <bool VEC>
__device__ inline void part_dpos(float (&dpos)[3][4][4], const float* __restrict__ graw,
                                 const float* __restrict__ gsa, const float* __restrict__ tgt,
                                 int p, const float om_v[4], const int vid[4], int J, int B,
                                 int Vt, int bc) {
  float tv[3][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (vid[i] >= 0 && vid[i] < Vt) {
        tmpl::load4<VEC>(tv[c][i], tgt + ((size_t)c * Vt + vid[i]) * B + bc, bc, B);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) tv[c][i][k] = 0.f;
      }
    }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float gs[4];
    tmpl::load4<VEC>(gs, gsa + ((size_t)d * J + p) * B + bc, bc, B);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dpos[d][i][k] = gs[k];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float wcd[4];
      tmpl::load4<VEC>(wcd, graw + ((size_t)(c * 3 + d) * J + p) * B + bc, bc, B);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) dpos[d][i][k] = fmaf(wcd[k], tv[c][i][k], dpos[d][i][k]);
    }
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dpos[d][i][k] *= om_v[i];
}

// dtgt_c = ω (gst[c, p] + sum_d graw[c*3+d, p] pos_d) at the thread's
// vertices below Vt, of one part p.
template <bool VEC>
__device__ inline void store_dtgt(float* __restrict__ dtgt, const float (&pos)[3][4][4],
                                  const float* __restrict__ graw, const float* __restrict__ gst,
                                  int p, const float om_v[4], const int vid[4], int J, int B,
                                  int Vt, int bc) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float dt[4][4], gs[4];
    tmpl::load4<VEC>(gs, gst + ((size_t)c * J + p) * B + bc, bc, B);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dt[i][k] = gs[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float wcd[4];
      tmpl::load4<VEC>(wcd, graw + ((size_t)(c * 3 + d) * J + p) * B + bc, bc, B);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) dt[i][k] = fmaf(wcd[k], pos[d][i][k], dt[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (vid[i] < 0 || vid[i] >= Vt) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) dt[i][k] *= om_v[i];
      tmpl::store4<VEC>(dtgt + ((size_t)c * Vt + vid[i]) * B + bc, dt[i], bc, B);
    }
  }
}

// This block's share (by blockIdx.y of gridDim.y) of the rows that no part
// holds, unused[0 .. n_unused): zero there dtgt (3, Vt, B) below Vt and a
// (3, Vp, B) field U, at the block's 128 columns from b0.
template <bool VEC>
__device__ inline void zero_unused(float* __restrict__ dtgt, float* __restrict__ U,
                                   const int* __restrict__ unused, int n_unused, int Vt, int Vp,
                                   int B, int b0) {
  const int u0 = (int)((long)n_unused * blockIdx.y / gridDim.y);
  const int u1 = (int)((long)n_unused * (blockIdx.y + 1) / gridDim.y);
  for (int idx = threadIdx.x; idx < (u1 - u0) * 3 * (TB / 4); idx += NT) {
    const int row = u0 + idx / (3 * (TB / 4)), c = (idx / (TB / 4)) % 3;
    const int b = b0 + 4 * (idx % (TB / 4));
    const int v = __ldg(unused + row);
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    if (v < Vt) tmpl::store4<VEC>(dtgt + ((size_t)c * Vt + v) * B + b, zero, b, B);
    tmpl::store4<VEC>(U + ((size_t)c * Vp + v) * B + b, zero, b, B);
  }
}

}  // namespace front
