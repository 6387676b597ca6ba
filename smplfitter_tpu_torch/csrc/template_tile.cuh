// The template dot and the active-joint blend of the kernels that walk
// vertex segments: K1 (lbs_points.cu), K2 (rhs_moments.cu), K4
// (recon_part_sums.cu) and K6 (recon_lbs_part_sums.cu); the blends and the
// warp reduce-scatter also serve the backward fronts of K10, K11, K12, K13
// and K14 (bwd_front.cuh).
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
// - The shape terms of the cached forms (K2 cached, K4, K13): a tile's shape
//   directions SD (3, V_pad, E) staged k-major ([c][e][vertex row], by 4-byte
//   cp.async), the solve's coefficients x (E, B) staged once per block
//   ([e][column]); the template h += SD x as a register-tiled dot (48 FMAs per
//   4 shared loads), and sum_v SD_v^T g_v by the warp reduce-scatter below.
//   K11 and K12 take their G = SD gr by the same dot, gr staged as x.
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
constexpr int MAXE = 32;                 // shape columns E <= 32
constexpr int EP = MAXE / 2;             // shape-row pairs of a reduce-scatter
constexpr int SDL = TV + 4;              // row stride of the staged shape directions
constexpr int SD_FLOATS = 3 * MAXE * SDL;  // one tile's shape directions: [c][e][SDL]

// consts copies: a warp covers 8 features of 4 rows, the block 16 rows (of
// the 3 TV rows (c, vertex)) per pass.
constexpr int A_ROWS_PER_PASS = 16;
constexpr int A_PASSES = 3 * TV / A_ROWS_PER_PASS;  // 6
constexpr int B_PASSES = B_FLOATS / 4 / NT;         // 2 float4 copies per thread
constexpr unsigned FULL = 0xffffffffu;

// Sum over the warp's 8 vertex groups (lane = 4 tm + q) of x[0..8), scattered:
// the lane of vertex group tm returns the sum of x[tm]. A fixed tree, so the
// result repeats bit for bit.
__device__ __forceinline__ float reduce_scatter8(const float (&x)[8], int tm) {
  const bool b2 = tm & 4, b1 = tm & 2, b0 = tm & 1;
  float y[4], z[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float keep = b2 ? x[q + 4] : x[q], send = b2 ? x[q] : x[q + 4];
    y[q] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float keep = b1 ? y[q + 2] : y[q], send = b1 ? y[q] : y[q + 2];
    z[q] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  const float keep = b0 ? z[1] : z[0], send = b0 ? z[0] : z[1];
  return keep + __shfl_xor_sync(FULL, send, 4);
}

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

// out[a][i][k] = sum_j w[vid_i, j] (sum_c pj[a*4+c, j, bc+k] h[c][i][k] +
// tr[a * tr_rows + j, bc+k]) over the segment's active joints jl[0 .. nA):
// the blended rotation applied to h plus a blended column per joint, joint
// by joint in list order, so only one joint's entries are live at a time.
template <bool VEC>
__device__ inline void blend_affine(float (&out)[3][4][4], const float (&h)[3][4][4],
                                    const float* __restrict__ pj, const float* __restrict__ tr,
                                    int tr_rows, const float* __restrict__ w,
                                    const int* __restrict__ jl, int nA, int J, int B, int bc,
                                    const int vid[4]) {
  zero(out);
  for (int jj = 0; jj < nA; ++jj) {
    const int j = __ldg(jl + jj);
    float wv[4];
    joint_weights(wv, w, vid, J, j);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float p[4][4];  // [c][column]: entries a*4 + c of the 4 columns, then the column of tr
#pragma unroll
      for (int c = 0; c < 3; ++c) load4<VEC>(p[c], pj + ((size_t)(a * 4 + c) * J + j) * B + bc, bc, B);
      load4<VEC>(p[3], tr + ((size_t)a * tr_rows + j) * B + bc, bc, B);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t = fmaf(p[0][k], h[0][i][k],
                          fmaf(p[1][k], h[1][i][k], fmaf(p[2][k], h[2][i][k], p[3][k])));
          out[a][i][k] = fmaf(wv[i], t, out[a][i][k]);
        }
    }
  }
}

// pos = the blended [R|t] applied to the homogeneous template h (blend_affine
// with the translation column pj[a*4+3]).
template <bool VEC>
__device__ inline void blend_pos(float (&pos)[3][4][4], const float (&h)[3][4][4],
                                 const float* __restrict__ pj, const float* __restrict__ w,
                                 const int* __restrict__ jl, int nA, int J, int B, int bc,
                                 const int vid[4]) {
  blend_affine<VEC>(pos, h, pj, pj + (size_t)3 * J * B, 4 * J, w, jl, nA, J, B, bc, vid);
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
        load4<VEC>(x[c][i], src + ((size_t)c * Vx + vid[i]) * B + bc, bc, B);
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
      store4<VEC>(dst + ((size_t)c * Vx + vid[i]) * B + bc, x[c][i], bc, B);
  }
}

// Copies a tile's shape directions into sd_s[(c * E + e) * SDL + row] by
// 4-byte cp.async (zero fill for the rows past n): rows[0 .. n) are the
// tile's vertices, sd (3, Vp, E). The caller commits the group.
__device__ inline void stage_shape_rows(float* sd_s, const float* __restrict__ sd,
                                        const int* rows, int n, int E, int Vp) {
  for (int idx = threadIdx.x; idx < 3 * E * TV; idx += NT) {
    const int e = idx % E, c = (idx / E) % 3, vv = idx / (3 * E);
    const int v = vv < n ? rows[vv] : -1;
    sgemm::cp_async4(sd_s + (c * E + e) * SDL + vv,
                     v >= 0 ? sd + ((size_t)c * Vp + v) * E + e : sd, v >= 0);
  }
}

// x_s[e * TB + c] = x[e, b0 + c] of an (E, B) array, zero past the batch edge.
__device__ inline void stage_columns(float* x_s, const float* __restrict__ x, int E, int B,
                                     int b0) {
  for (int idx = threadIdx.x; idx < E * TB; idx += NT) {
    const int e = idx / TB, b = b0 + idx % TB;
    x_s[idx] = b < B ? __ldg(x + (size_t)e * B + b) : 0.f;
  }
}

// h[c][i][k] += sum_e SD[c, vertex 4 tm + i, e] x[e, column 4 tn + k], one
// FMA per term in e order, from the staged shape directions (sd_s) and
// coefficients (x_s).
__device__ inline void add_shape_dot(float (&h)[3][4][4], const float* sd_s, const float* x_s,
                                     int E, int tm, int tn) {
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    const float4 x4 = *reinterpret_cast<const float4*>(x_s + e * TB + 4 * tn);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 s4 = *reinterpret_cast<const float4*>(sd_s + (c * E + e) * SDL + 4 * tm);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) h[c][i][k] = fmaf(sv[i], xv[k], h[c][i][k]);
    }
  }
}

// acc[p] += sum over the tile's vertices of sum_c SD[c, v, e] g_c(v), e =
// 2p + tm / 4, column bc + tm % 4 (the lane's own entries; the warp holds the
// tile's 32 vertices of 16 columns, lane = 4 tm + column group), with the
// tile's shape directions in sd_s.
__device__ inline void add_shape_rows(float (&acc)[EP], const float (&g)[3][4][4],
                                      const float* sd_s, int E, int tm) {
#pragma unroll
  for (int p = 0; p < EP; ++p) {
    if (2 * p >= E) break;  // uniform across the block
    float x[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = 2 * p + q;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * q + k] = 0.f;
      if (e >= E) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 s4 = *reinterpret_cast<const float4*>(sd_s + (c * E + e) * SDL + 4 * tm);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) x[4 * q + k] = fmaf(sv[i], g[c][i][k], x[4 * q + k]);
      }
    }
    acc[p] += reduce_scatter8(x, tm);
  }
}

}  // namespace tmpl
