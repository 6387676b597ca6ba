// Shared tile routines of the backward LBS kernels K11 and K12 (lbs_bwd.cuh
// and the kernel on it: rhs_bwd.cu). The forward kernels K1, K2, K4 and K6
// and the backward kernels K10, K13 and K14 walk vertex segments through
// template_tile.cuh instead.
//
// A block of 256 threads owns a tile of TV vertices x TB batch columns; each
// thread owns a 4 x 4 micro-tile: tile rows ty + 16 i and batch columns
// b0 + tx + 16 k (ty = tid / 16, tx = tid % 16). A tile's rows are TV
// consecutive vertices (TileRows). A warp's 16 tx lanes read and write 16
// consecutive batch columns (batch is the contiguous axis of every (C, V, B)
// operand). All arithmetic is f32 on the CUDA cores: the homog dot (K = F)
// and the blend (K = J) are shared-memory-tiled register-blocked loops, no
// tensor cores and no TF32.
#pragma once

#include <cuda_runtime.h>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace lbs {

constexpr int NT = 256;       // threads per block
constexpr int TV = 64;        // vertices per tile
constexpr int TB = 64;        // batch columns per tile
constexpr int TVP = TV + 1;   // padded vertex stride of transposed smem tiles
constexpr int KF = 16;        // feature rows staged per step of the homog dot

// Shared-memory floats of the staging area used by homog_tile.
__host__ __device__ constexpr int staging_floats() { return KF * TB + 3 * KF * TVP; }

// pj_s[(x * J + j) * TB + bb] = pj[x, j, b0 + bb] (zero past the batch edge).
__device__ inline void load_pj_tile(float* pj_s, const float* __restrict__ pj,
                                    int J, int B, int b0) {
  const int n = 12 * J * TB;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int bb = idx % TB;
    const int xj = idx / TB;
    const int b = b0 + bb;
    pj_s[idx] = (b < B) ? pj[(size_t)xj * B + b] : 0.f;
  }
}

// The vertex of tile row vv, or -1 for none: TV consecutive vertices from v0,
// masked at the vertex edge Vp.
struct TileRows {
  int v0, Vp;
  __device__ int operator()(int vv) const { return v0 + vv < Vp ? v0 + vv : -1; }
};

// w_s[j * TVP + vv] = w[rows(vv), j] (zero for a row with no vertex).
template <class Rows>
__device__ inline void load_w_tile(float* w_s, const float* __restrict__ w, int J, Rows rows) {
  const int n = TV * J;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const int j = idx % J;
    const int vv = idx / J;
    const int v = rows(vv);
    w_s[j * TVP + vv] = (v >= 0) ? w[(size_t)v * J + j] : 0.f;
  }
}

// h[c][i][k] = sum_f consts[c, v, f] * feat[f, b], c = 0..2 (the posed
// homogeneous template; its 4th channel is identically 1 and never formed),
// zero for a row with no vertex. Vp is the row stride of consts. Starts and
// ends with a block barrier; `stage` holds staging_floats().
template <class Rows>
__device__ inline void homog_tile(float h[3][4][4], const float* __restrict__ feat,
                                  const float* __restrict__ consts, int F, int B,
                                  int Vp, Rows rows, int b0, float* stage) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* feat_s = stage;             // [KF][TB]
  float* consts_s = stage + KF * TB; // [3][KF][TVP]
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) h[c][i][k] = 0.f;

  for (int f0 = 0; f0 < F; f0 += KF) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KF * TB; idx += NT) {
      const int kk = idx / TB, bb = idx % TB;
      const int f = f0 + kk, b = b0 + bb;
      feat_s[idx] = (f < F && b < B) ? feat[(size_t)f * B + b] : 0.f;
    }
    for (int idx = threadIdx.x; idx < 3 * TV * KF; idx += NT) {
      const int kk = idx % KF;
      const int rest = idx / KF;
      const int vv = rest % TV, c = rest / TV;
      const int f = f0 + kk, v = rows(vv);
      consts_s[(c * KF + kk) * TVP + vv] =
          (f < F && v >= 0) ? consts[((size_t)c * Vp + v) * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KF; ++kk) {
      float fb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) fb[k] = feat_s[kk * TB + tx + 16 * k];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = consts_s[(c * KF + kk) * TVP + ty + 16 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) h[c][i][k] = fmaf(cv[i], fb[k], h[c][i][k]);
      }
    }
  }
  __syncthreads();
}

// pos[a][i][k] = sum_j w[v, j] (sum_c pj[a*4+c, j, b] h[c] + pj[a*4+3, j, b]):
// the blended [R|t] applied to the homogeneous template, with the joint sum
// outermost so only one joint's 12 entries are live at a time.
__device__ inline void pos_tile(float pos[3][4][4], const float h[3][4][4],
                                const float* pj_s, const float* w_s, int J) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) pos[a][i][k] = 0.f;

  for (int j = 0; j < J; ++j) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w_s[j * TVP + ty + 16 * i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float p[12];
#pragma unroll
      for (int x = 0; x < 12; ++x) p[x] = pj_s[(x * J + j) * TB + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float t = fmaf(p[a * 4 + 0], h[0][i][k],
                    fmaf(p[a * 4 + 1], h[1][i][k],
                    fmaf(p[a * 4 + 2], h[2][i][k], p[a * 4 + 3])));
          pos[a][i][k] = fmaf(wv[i], t, pos[a][i][k]);
        }
    }
  }
}

// g_c = (Rbar^T field)_c = sum_j w[v, j] sum_a pj[a*4+c, j, b] field_a: a
// per-vertex field projected on the blended rotation's columns.
__device__ inline void project_rbar(float g[3][4][4], const float field[3][4][4],
                                    const float* pj_s, const float* w_s, int J) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) g[c][i][k] = 0.f;
  for (int j = 0; j < J; ++j) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w_s[j * TVP + ty + 16 * i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float p[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) p[a * 3 + c] = pj_s[((a * 4 + c) * J + j) * TB + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float s = fmaf(p[c], field[0][i][k],
                               fmaf(p[3 + c], field[1][i][k], p[6 + c] * field[2][i][k]));
          g[c][i][k] = fmaf(wv[i], s, g[c][i][k]);
        }
    }
  }
}

// work[row * TB + col] = one coordinate of a field on this thread's
// micro-tile, then a barrier.
__device__ inline void stage_coord(float* work, const float f[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) work[(ty + 16 * i) * TB + tx + 16 * k] = f[i][k];
  __syncthreads();
}

}  // namespace lbs
