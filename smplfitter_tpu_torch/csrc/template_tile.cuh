// The template dot and the active-joint blend of the kernels that walk
// vertex segments: K1 (lbs_points.cu), K2 (rhs_moments.cu) and K6
// (recon_lbs_part_sums.cu).
//
// A block of 256 threads owns 128 batch columns and walks tiles of 32 listed
// vertices (a tile's rows are a list in shared memory: the vertex of each
// row, -1 for none). Each thread owns 4 vertices x 4 columns x 3 channels of
// the posed homogeneous template
//     h_c(v, b) = sum_f consts[c, v, f] feat[f, b]   (c = 0..2; channel 3 is 1),
// tile rows 4 tm .. 4 tm + 3 and columns 4 tn .. 4 tn + 3; the kernel picks
// the warp layout of (tm, tn) (tm < 8, tn < 32).
// - The F-deep dot is a register-tiled GEMM (the pattern of sgemm_tile.cuh):
//   per feature a thread reads three float4 of the consts stage (4 vertices,
//   one per channel) and one of the feat stage (4 columns): 48 FMAs per 4
//   shared loads, broadcasts within a warp. Features go 16 at a time through
//   a 4-stage cp.async ring that runs on across tile boundaries, so the next
//   tile's first stages load while this tile's epilogue runs. consts rows
//   are gathered through the tile's vertex list, each element by a 4-byte
//   copy to its k-major place (F is odd: no 16-byte copy fits), a warp copying
//   8 features of 4 rows into 32 banks; feat by 16-byte copies where
//   B % 4 == 0 (VEC).
// - The blend runs over the active joints of the tile's segment only (the
//   joints with a nonzero weight on any of its vertices, listed by the host:
//   BlendSegments and PartIndex in ops/lbs_kernels.py); the terms left out
//   are products with exact zeros. The joints' [R|t] entries and weights are
//   read from global memory (L1) as they are used, so a long list (dense
//   weights) runs the same loop.
// All arithmetic is f32 FMAs on the CUDA cores (no TF32, no tensor cores).
#pragma once

#include "sgemm_tile.cuh"

namespace tmpl {

constexpr int NT = 256;              // threads per block
constexpr int TV = 32;               // listed vertices per tile
constexpr int TB = 128;              // batch columns per block
constexpr int KT = 16;               // features per k tile
constexpr int NSTG = 4;              // stages of the copy ring
constexpr int LDA = TV + 4;          // row stride of the k-major consts stage
constexpr int A_FLOATS = 3 * KT * LDA;  // [c][k][LDA]
constexpr int B_FLOATS = KT * TB;       // [k][TB]
constexpr int STG_FLOATS = A_FLOATS + B_FLOATS;
constexpr int RING_FLOATS = NSTG * STG_FLOATS;

// consts copies: a warp covers 8 features of 4 rows, the block 16 rows (of
// the 3 TV rows (c, vertex)) per pass.
constexpr int A_ROWS_PER_PASS = 16;
constexpr int A_PASSES = 3 * TV / A_ROWS_PER_PASS;  // 6
constexpr int B_PASSES = B_FLOATS / 4 / NT;         // 2 float4 copies per thread

// The copy ring of the template dot: step s is k tile s % nk of tile s / nk,
// in slot s % NSTG of `ring` (RING_FLOATS floats of shared memory).
template <bool VEC>
struct Ring {
  float* ring;
  const int* rows;  // shared: tile t's vertices at rows[t * TV ...]
  const float* __restrict__ feat;
  const float* __restrict__ consts;
  int F, B, Vp, b0, nk;
  int ka, ra, kb, cb;  // this thread's consts copies: feature ka of rows ra + 16 q;
  bool live_b;         // feat copies: columns 4 cb .. 4 cb + 3 of features kb + 8 q

  __device__ Ring(float* ring_, const int* rows_, const float* feat_, const float* consts_,
                  int F_, int B_, int Vp_, int b0_)
      : ring(ring_), rows(rows_), feat(feat_), consts(consts_), F(F_), B(B_), Vp(Vp_), b0(b0_) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    nk = (F + KT - 1) / KT;
    ka = 8 * (warp % 2) + lane % 8;
    ra = 4 * (warp / 2) + lane / 8;
    kb = threadIdx.x / (TB / 4);
    cb = threadIdx.x % (TB / 4);
    live_b = b0 + 4 * cb < B;
  }

  __device__ void issue(int step) const {
    const int tile = step / nk, f0 = (step % nk) * KT;
    float* as = ring + (step % NSTG) * STG_FLOATS;
    float* bs = as + A_FLOATS;
    const bool live_k = f0 + ka < F;
#pragma unroll
    for (int q = 0; q < A_PASSES; ++q) {
      const int row = ra + A_ROWS_PER_PASS * q;  // (c, vertex) = (row / TV, row % TV)
      const int c = row / TV, vv = row % TV;
      const int v = rows[tile * TV + vv];
      const bool live = live_k && v >= 0;
      sgemm::cp_async4(as + (c * KT + ka) * LDA + vv,
                       live ? consts + ((size_t)c * Vp + v) * F + f0 + ka : consts, live);
    }
    if (VEC) {
#pragma unroll
      for (int q = 0; q < B_PASSES; ++q) {
        const int k = kb + (NT / (TB / 4)) * q;
        const bool live = live_b && f0 + k < F;
        sgemm::cp_async16(bs + k * TB + 4 * cb,
                          live ? feat + (size_t)(f0 + k) * B + b0 + 4 * cb : feat, live);
      }
    } else {
      for (int e = threadIdx.x; e < B_FLOATS; e += NT) {
        const int k = e / TB, bb = e % TB;
        const bool live = f0 + k < F && b0 + bb < B;
        sgemm::cp_async4(bs + e, live ? feat + (size_t)(f0 + k) * B + b0 + bb : feat, live);
      }
    }
  }
};

__device__ __forceinline__ void zero(float (&x)[3][4][4]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[c][i][k] = 0.f;
}

// Walks `n_tiles` tiles through the ring: the template dot of each tile into
// h, then epilogue(tile, h) once the tile's last k tile is in. Starts with
// no copy in flight and ends with none; every step starts with a block
// barrier, so consecutive epilogues are separated by one (nk >= 1).
template <bool VEC, class Epilogue>
__device__ inline void walk_tiles(const Ring<VEC>& rg, int n_tiles, int tm, int tn,
                                  Epilogue&& epilogue) {
  float h[3][4][4];
  zero(h);
  const int nk = rg.nk;
  const int n_steps = n_tiles * nk;
#pragma unroll
  for (int st = 0; st < NSTG - 1; ++st) {
    if (st < n_steps) rg.issue(st);
    sgemm::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    // Step `step` has landed; step - 1 is consumed, so its slot takes step + NSTG - 1.
    sgemm::cp_async_wait<NSTG - 2>();
    __syncthreads();
    if (step + NSTG - 1 < n_steps) rg.issue(step + NSTG - 1);
    sgemm::cp_async_commit();
    const float* as = rg.ring + (step % NSTG) * STG_FLOATS;
    const float* bs = as + A_FLOATS;
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 fb = *reinterpret_cast<const float4*>(bs + k * TB + 4 * tn);
      const float fv[4] = {fb.x, fb.y, fb.z, fb.w};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 cv4 = *reinterpret_cast<const float4*>(as + (c * KT + k) * LDA + 4 * tm);
        const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) h[c][i][kk] = fmaf(cv[i], fv[kk], h[c][i][kk]);
      }
    }
    if ((step + 1) % nk != 0) continue;
    epilogue(step / nk, h);
    zero(h);
  }
  sgemm::cp_async_wait<0>();
}

// v[k] = src[k] for the columns bc + k < B (src: a row's element at column
// bc), zero past the batch edge; one float4 where VEC (B % 4 == 0, 16-byte
// aligned rows).
template <bool VEC>
__device__ __forceinline__ void load4(float v[4], const float* __restrict__ src, int bc, int B) {
  if (VEC) {
    const float4 v4 = bc < B ? __ldg(reinterpret_cast<const float4*>(src))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = v4.x;
    v[1] = v4.y;
    v[2] = v4.z;
    v[3] = v4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = bc + k < B ? __ldg(src + k) : 0.f;
  }
}

// dst[k] = v[k] for the columns bc + k < B.
template <bool VEC>
__device__ __forceinline__ void store4(float* dst, const float v[4], int bc, int B) {
  if (VEC) {
    if (bc < B) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (bc + k < B) dst[k] = v[k];
  }
}

// The weights w[vid_i, j] of one joint (zero for a row with no vertex).
__device__ __forceinline__ void joint_weights(float wv[4], const float* __restrict__ w,
                                              const int vid[4], int J, int j) {
#pragma unroll
  for (int i = 0; i < 4; ++i) wv[i] = vid[i] >= 0 ? __ldg(w + (size_t)vid[i] * J + j) : 0.f;
}

// pos[a][i][k] = sum_j w[vid_i, j] (sum_c pj[a*4+c, j, bc+k] h[c][i][k] +
// pj[a*4+3, j, bc+k]) over the segment's active joints jl[0 .. nA): the
// blended [R|t] applied to the homogeneous template, joint by joint in list
// order, so only one joint's entries are live at a time.
template <bool VEC>
__device__ inline void blend_pos(float (&pos)[3][4][4], const float (&h)[3][4][4],
                                 const float* __restrict__ pj, const float* __restrict__ w,
                                 const int* __restrict__ jl, int nA, int J, int B, int bc,
                                 const int vid[4]) {
  zero(pos);
  for (int jj = 0; jj < nA; ++jj) {
    const int j = __ldg(jl + jj);
    float wv[4];
    joint_weights(wv, w, vid, J, j);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float p[4][4];  // [c][column]: entries a*4 + c of the 4 columns
#pragma unroll
      for (int c = 0; c < 4; ++c) load4<VEC>(p[c], pj + ((size_t)(a * 4 + c) * J + j) * B + bc, bc, B);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t = fmaf(p[0][k], h[0][i][k],
                          fmaf(p[1][k], h[1][i][k], fmaf(p[2][k], h[2][i][k], p[3][k])));
          pos[a][i][k] = fmaf(wv[i], t, pos[a][i][k]);
        }
    }
  }
}

// g[c][i][k] = (Rbar^T f)_c = sum_j w[vid_i, j] sum_a pj[a*4+c, j, bc+k]
// f[a][i][k] over the segment's active joints: a per-vertex field projected
// on the blended rotation's columns.
template <bool VEC>
__device__ inline void blend_project(float (&g)[3][4][4], const float (&f)[3][4][4],
                                     const float* __restrict__ pj, const float* __restrict__ w,
                                     const int* __restrict__ jl, int nA, int J, int B, int bc,
                                     const int vid[4]) {
  zero(g);
  for (int jj = 0; jj < nA; ++jj) {
    const int j = __ldg(jl + jj);
    float wv[4];
    joint_weights(wv, w, vid, J, j);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float p[3][4];  // [a][column]: entries a*4 + c of the 4 columns
#pragma unroll
      for (int a = 0; a < 3; ++a) load4<VEC>(p[a], pj + ((size_t)(a * 4 + c) * J + j) * B + bc, bc, B);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float s = fmaf(p[0][k], f[0][i][k],
                          fmaf(p[1][k], f[1][i][k], p[2][k] * f[2][i][k]));
          g[c][i][k] = fmaf(wv[i], s, g[c][i][k]);
        }
    }
  }
}

}  // namespace tmpl
