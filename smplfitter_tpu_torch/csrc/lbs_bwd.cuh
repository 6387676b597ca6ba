// Shared pieces of the backward kernels K11 and K12 (rhs_bwd.cu) and K13
// (recon_bwd.cu). K10 and K14 walk vertex segments instead (bwd_front.cuh).
//
// Each backward kernel walks the same tiles as its forward kernel (lbs_tile.cuh:
// a block of 256 threads owns 64 batch columns and a split of the vertex
// axis, 64 vertices per tile, each thread a 4 x 4 micro-tile of rows ty + 16 i
// and columns tx + 16 k) and reduces per-vertex fields over the vertices into
// per-column outputs: dpj (12, J, B) = sum_v w_vj dblend_x(v), and dfeat
// (F, B) = sum_c consts_c^T u_c or dx (E, B) = sum_c SD_c^T dh_c. Every such
// reduction is one GEMM over the tile's 64 vertices: a field coordinate is
// staged in shared memory ([TV][TB]), a coefficient matrix ([rows][TVP]: the
// weights, the consts or the shape directions of the tile's vertices) is read
// from shared memory, and each thread keeps a 4 x 4 block of (row, column)
// sums in registers (8 shared loads per 16 FMAs). The sums of a vertex split
// go to the block's own slice of per-split partials in device memory (one
// owner thread per entry, no atomics); split_sum_kernel adds the splits in
// order, so two runs give the same bits.
#pragma once

#include "lbs_tile.cuh"

namespace bwd {

using namespace lbs;

constexpr int ROWS = 64;  // coefficient rows per pass of rows_dot (ty + 16 m, m < 4)

// Floats of the staging area: homog_tile's staging or one [TV][TB] field tile.
__host__ __device__ constexpr int work_floats() {
  return staging_floats() > TV * TB ? staging_floats() : TV * TB;
}

// acc[m][k] += sum_vv coef[r_m * TVP + vv] * work[vv * TB + tx + 16 k] with
// r_m = ty + 16 m, clamped to the last live row (nrows <= ROWS): a clamped
// row repeats a live one and is never flushed.
__device__ inline void rows_dot(float acc[4][4], const float* coef, const float* work,
                                int nrows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) off[m] = min(ty + 16 * m, nrows - 1) * TVP;
#pragma unroll 4
  for (int vv = 0; vv < TV; ++vv) {
    float c[4], f[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) c[m] = coef[off[m] + vv];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = work[vv * TB + tx + 16 * k];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][k] = fmaf(c[m], f[k], acc[m][k]);
  }
}

__device__ inline void zero4(float acc[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[m][k] = 0.f;
}

// part[(row0 + r) * B + b] += acc for the live rows r = ty + 16 m < nrows and
// columns b = b0 + tx + 16 k < B (part: the block's split slice).
__device__ inline void flush_rows(float* part, int row0, const float acc[4][4], int nrows,
                                  int B, int b0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ty + 16 * m;
    if (r >= nrows) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = b0 + tx + 16 * k;
      if (b < B) part[(size_t)(row0 + r) * B + b] += acc[m][k];
    }
  }
}

// part rows [row0 + j] += sum_v w[v, j] f(v), j < J <= ROWS, for one field
// coordinate f on the tile (w_s: the tile's weights [J][TVP]). Starts by
// staging f (a barrier) and ends with a barrier.
__device__ inline void reduce_joint_field(float* part, int row0, const float f[4][4],
                                          const float* w_s, float* work, int J, int B, int b0) {
  float acc[4][4];
  zero4(acc);
  stage_coord(work, f);
  rows_dot(acc, w_s, work, J);
  __syncthreads();
  flush_rows(part, row0, acc, J, B, b0);
}

// part rows [row0 + f] += sum_c sum_v consts[c, v, f] u_c(v), f < F, for the
// tile's 64 consecutive vertices from v0 (consts (>= 3, Vp, F), row stride Vp):
// 64 feature rows per pass, the tile's consts slice staged per channel in
// coef_s ([ROWS][TVP]). Ends with a barrier.
__device__ inline void reduce_feat(float* part, int row0, const float u[3][4][4],
                                   const float* __restrict__ consts, int F, int Vp, int v0,
                                   int B, int b0, float* work, float* coef_s) {
  for (int f0 = 0; f0 < F; f0 += ROWS) {
    const int nf = min(ROWS, F - f0);
    float acc[4][4];
    zero4(acc);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int idx = threadIdx.x; idx < TV * ROWS; idx += NT) {
        const int fr = idx % ROWS, vv = idx / ROWS;
        const int v = v0 + vv, f = f0 + fr;
        coef_s[fr * TVP + vv] = (v < Vp && f < F) ? consts[((size_t)c * Vp + v) * F + f] : 0.f;
      }
      stage_coord(work, u[c]);  // its barrier also publishes coef_s
      rows_dot(acc, coef_s, work, nf);
      __syncthreads();
    }
    flush_rows(part, row0 + f0, acc, nf, B, b0);
  }
}

// Zero the block's split slice (R rows of its 64 columns) of the partials.
__device__ inline void zero_split(float* part_blk, int R, int B, int b0) {
  for (int idx = threadIdx.x; idx < R * TB; idx += NT) {
    const int b = b0 + idx % TB;
    if (b < B) part_blk[(size_t)(idx / TB) * B + b] = 0.f;
  }
}

// r (3, Vx, B) -> the thread's micro-tile of rows v0 + ty + 16 i < nv (zero
// elsewhere and past the batch edge).
__device__ inline void load_field(float f[3][4][4], const float* __restrict__ src, int Vx,
                                  int nv, int v0, int B, int b0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = b0 + tx + 16 * k;
      const bool ok = v < nv && b < B;
#pragma unroll
      for (int a = 0; a < 3; ++a) f[a][i][k] = ok ? src[((size_t)a * Vx + v) * B + b] : 0.f;
    }
  }
}

// dst (3, Vx, B) <- the thread's micro-tile, rows v0 + ty + 16 i < nv.
__device__ inline void store_field(float* dst, const float f[3][4][4], int Vx, int nv, int v0,
                                   int B, int b0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= nv) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = b0 + tx + 16 * k;
      if (b >= B) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) dst[((size_t)a * Vx + v) * B + b] = f[a][i][k];
    }
  }
}

}  // namespace bwd

#include "split_sum.cuh"
