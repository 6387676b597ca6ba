// K2: fused residual projection of the shape solve, in five forms.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_rhs_kernel
// (launcher _rhs_moments_impl; APIs rhs_moments_h, rhs_moments,
// rhs_moments(scale=True) and rhs_moments_cached with and without scale). Per
// vertex and batch column: the posed template homog_c = consts_c . feat, the
// LBS position pos = blended [R|t] . homog, the residual b = tgt - pos, and
// its two vertex reductions
//     y[a, j, :] = sum_v w[v, j] b_a(v)                        (3, J, B)
//     r[e, :]    = sum_v sum_c SD[c, v, e] (Rbar_v^T b_v)_c     (E, B)
// where Rbar_v is the rotation part of the blended transform. The forms are
// compile-time variants of one kernel:
//   - emit-homog (EMIT): also writes homog (3, V_pad, B) for this iteration's
//     cached recon kernel (K4);
//   - plain: y and r only; no homog store (it would be ~340 MB of writes per
//     call at SMPL b4096 that nobody reads);
//   - scale (SCALE): also the target-side moments of the scale column,
//     yt[a, j] = sum_v w[v, j] t_a(v), rt[e] = sum_v sum_c SD[c, v, e]
//     (Rbar_v^T t_v)_c and sc = [sum |t|^2, sum t.pos, sum |pos|^2] (3, B);
//   - cached (CACHED, plain or with SCALE): reads homog (3, V_pad, B), the
//     posed template that K7 (posed_template.cu) computed once per solve,
//     instead of running the F-deep homog dot. The large-F models (SMPL-X
//     F = 487, SMPL+H F = 460) take it;
//   - fit-weighted (W, with any of the above): a fitter's static fit weights,
//     the column ω (V_pad, 1), multiply b, and in the scale form t and the
//     three second moments, so every sum is ω-weighted (the JAX package's
//     static-ω form; per-call weights take K9, wgram.cu).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, batch column): 3F
// FMAs of homog dot (none in the cached form), 12J of position, 12J of the
// Rbar^T b projection and 3J + 3E of reductions (twice the last two in the
// scale form); at SMPL b4096 (F = 208, J = 24, E = 10) about
// 7168 * 4096 * 1300 * 2 = 76 GFLOP against ~0.35 GB of traffic; at SMPL-X
// b4096 cached (J = 55, E = 16) about 10496 * 4096 * 1500 * 2 = 129 GFLOP
// against ~1 GB (targets and homog in).
//
// Design: the TPU grid swept the vertex chunks of a batch tile in order and
// accumulated into the output block. Here blocks run in parallel with no
// order, so a block owns (batch tile, vertex split): it walks its split's
// 64-vertex tiles and accumulates the output rows of its 64 columns in its own
// slice of the per-split partials in device memory (one owner thread per
// entry, so no atomics; the slice stays in L2). A second kernel sums the
// partials over splits in a fixed order, so runs repeat bit for bit. Shared
// memory holds the batch tile's [R|t] entries, the tile's weights and shape
// directions and one 64 x 64 staging tile, which one coordinate of a field at
// a time passes through for the reductions: 213 KB at J = 55, E = 17. The homog
// dot and the position reuse the shared tile routines of K1; the residual
// never leaves registers except through the staging tile. The scale form runs
// the same two reductions a second time on the targets and adds three
// per-column sums. The target's vertex edge (V_t <= V_pad rows) and the batch
// edge are masked by global index.
#include "lbs_tile.cuh"

using namespace lbs;

namespace {

constexpr int NG = NT / TB;          // column groups of the reductions (4)
constexpr int MAXE = 32;             // E <= 32
constexpr int EPT = MAXE / NG;       // shape rows per thread in reduce_sd_rows

// Output rows of the partials: y (3J), r (E) [, yt (3J), rt (E), sc (3)].
__host__ __device__ inline int rhs_rows(int J, int E, bool scale) {
  return scale ? 6 * J + 2 * E + 3 : 3 * J + E;
}

// part[row0 + a*J + j] += sum_vv w[v, j] field_a(v), for the block's columns
// (part points at the block's split, row stride B). Ends with a barrier.
__device__ inline void reduce_joint_rows(float* part, int row0, const float field[3][4][4],
                                         const float* w_s, float* work, int J, int B, int b0) {
  const int col = threadIdx.x % TB, grp = threadIdx.x / TB;
  const int b = b0 + col;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    stage_coord(work, field[a]);
    if (b < B) {
      for (int j = grp; j < J; j += NG) {
        float s = 0.f;
#pragma unroll 8
        for (int vv = 0; vv < TV; ++vv) s = fmaf(w_s[j * TVP + vv], work[vv * TB + col], s);
        part[(size_t)(row0 + a * J + j) * B + b] += s;
      }
    }
    __syncthreads();
  }
}

// part[row0 + e] += sum_vv sum_c SD[c, v, e] g_c(v). Ends with a barrier.
__device__ inline void reduce_sd_rows(float* part, int row0, const float g[3][4][4],
                                      const float* sd_s, float* work, int E, int B, int b0) {
  const int col = threadIdx.x % TB, grp = threadIdx.x / TB;
  const int b = b0 + col;
  float s[EPT];
#pragma unroll
  for (int m = 0; m < EPT; ++m) s[m] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    stage_coord(work, g[c]);
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int e = grp + NG * m;
      if (e < E) {
#pragma unroll 8
        for (int vv = 0; vv < TV; ++vv)
          s[m] = fmaf(sd_s[(c * E + e) * TVP + vv], work[vv * TB + col], s[m]);
      }
    }
    __syncthreads();
  }
  if (b < B) {
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
      const int e = grp + NG * m;
      if (e < E) part[(size_t)(row0 + e) * B + b] += s[m];
    }
  }
}

template <bool EMIT, bool SCALE, bool CACHED, bool W>
__global__ void __launch_bounds__(NT, 1)
rhs_moments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                   const float* __restrict__ feat, const float* __restrict__ w,
                   const float* __restrict__ consts, const float* __restrict__ sd,
                   const float* __restrict__ om, float* __restrict__ homog,
                   float* __restrict__ part, int J, int B, int F, int E, int Vt, int Vp,
                   int tiles_per_block) {
  extern __shared__ float smem[];
  const int R = rhs_rows(J, E, SCALE);
  float* pj_s = smem;                   // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;      // [J][TVP]
  float* sd_s = w_s + J * TVP;          // [3][E][TVP]
  float* work = sd_s + 3 * E * TVP;     // homog staging, or a [TV][TB] reduction tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col = threadIdx.x % TB, grp = threadIdx.x / TB;
  const int b0 = blockIdx.x * TB;
  float* part_blk = part + (size_t)blockIdx.y * R * B;

  load_pj_tile(pj_s, pj, J, B, b0);
  for (int idx = threadIdx.x; idx < R * TB; idx += NT) {
    const int b = b0 + idx % TB;
    if (b < B) part_blk[(size_t)(idx / TB) * B + b] = 0.f;
  }

  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, sd_s and work
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    for (int idx = threadIdx.x; idx < TV * 3 * E; idx += NT) {
      const int ce = idx % (3 * E), vv = idx / (3 * E);
      const int v = v0 + vv;
      sd_s[ce * TVP + vv] = (v < Vp) ? sd[((size_t)(ce / E) * Vp + v) * E + ce % E] : 0.f;
    }

    float h[3][4][4];
    if (CACHED) {
      __syncthreads();  // publishes w_s and sd_s (homog_tile's barriers do it otherwise)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty + 16 * i;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = b0 + tx + 16 * k;
          const bool ok = v < Vp && b < B;
#pragma unroll
          for (int c = 0; c < 3; ++c) h[c][i][k] = ok ? homog[((size_t)c * Vp + v) * B + b] : 0.f;
        }
      }
    } else {
      homog_tile(h, feat, consts, F, B, Vp, rows, b0, work);
    }
    if (EMIT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty + 16 * i;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = b0 + tx + 16 * k;
          if (v < Vp && b < B) {
#pragma unroll
            for (int c = 0; c < 3; ++c) homog[((size_t)c * Vp + v) * B + b] = h[c][i][k];
          }
        }
      }
    }

    // Residual b = tgt - pos (zero outside the target's rows and the batch);
    // the scale form keeps the masked targets and its three per-column sums.
    float res[3][4][4], tv[3][4][4], sc[3][4];
    pos_tile(res, h, pj_s, w_s, J);
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[0][k] = sc[1][k] = sc[2][k] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
      const float wv = W ? (v < Vt ? om[v] : 0.f) : 1.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b0 + tx + 16 * k;
        const bool ok = v < Vt && b < B;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float tval = ok ? tgt[((size_t)a * Vt + v) * B + b] : 0.f;
          const float pval = ok ? res[a][i][k] : 0.f;
          if (SCALE) {
            const float tw = W ? tval * wv : tval;
            tv[a][i][k] = tw;
            sc[0][k] = fmaf(tw, tval, sc[0][k]);
            sc[1][k] = fmaf(tw, pval, sc[1][k]);
            sc[2][k] = fmaf(W ? pval * wv : pval, pval, sc[2][k]);
          }
          res[a][i][k] = W ? (tval - pval) * wv : tval - pval;
        }
      }
    }

    float g[3][4][4];
    project_rbar(g, res, pj_s, w_s, J);
    reduce_joint_rows(part_blk, 0, res, w_s, work, J, B, b0);
    reduce_sd_rows(part_blk, 3 * J, g, sd_s, work, E, B, b0);

    if (SCALE) {
      // sc rows: per-column sums over the tile's rows, summed over ty in order.
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) work[(s * 16 + ty) * TB + tx + 16 * k] = sc[s][k];
      __syncthreads();
      const int b = b0 + col;
      for (int s = grp; s < 3; s += NG) {
        float sum = 0.f;
        for (int y = 0; y < 16; ++y) sum += work[(s * 16 + y) * TB + col];
        if (b < B) part_blk[(size_t)(6 * J + 2 * E + s) * B + b] += sum;
      }
      __syncthreads();
      project_rbar(g, tv, pj_s, w_s, J);
      reduce_joint_rows(part_blk, 3 * J + E, tv, w_s, work, J, B, b0);
      reduce_sd_rows(part_blk, 6 * J + E, g, sd_s, work, E, B, b0);
    }
  }
}

// Sums the per-split partials in split order into the outputs: rows [0, 3J)
// -> y, then E rows -> r, and in the scale form 3J rows -> yt, E -> rt, 3 -> sc.
__global__ void rhs_split_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                                     float* __restrict__ r_out, float* __restrict__ yt,
                                     float* __restrict__ rt, float* __restrict__ sc,
                                     int n_splits, int J, int E, int R, int B) {
  const size_t n = (size_t)R * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part[(size_t)sp * n + idx];
    const int row = (int)(idx / B);
    const size_t b = idx % B;
    if (row < 3 * J) y[idx] = s;
    else if (row < 3 * J + E) r_out[(size_t)(row - 3 * J) * B + b] = s;
    else if (row < 6 * J + E) yt[(size_t)(row - 3 * J - E) * B + b] = s;
    else if (row < 6 * J + 2 * E) rt[(size_t)(row - 6 * J - E) * B + b] = s;
    else sc[(size_t)(row - 6 * J - 2 * E) * B + b] = s;
  }
}

template <bool EMIT, bool SCALE, bool CACHED, bool W>
cudaError_t launch_variant(const float* tgt, const float* pj, const float* feat, const float* w,
                           const float* consts, const float* sd, const float* om, float* homog,
                           float* part, int J, int B, int F, int E, int Vt, int Vp,
                           int tiles_per_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rhs_moments_kernel<EMIT, SCALE, CACHED, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  dim3 grid((B + TB - 1) / TB, n_splits);
  rhs_moments_kernel<EMIT, SCALE, CACHED, W><<<grid, NT, smem, stream>>>(
      tgt, pj, feat, w, consts, sd, om, homog, part, J, B, F, E, Vt, Vp, tiles_per_block);
  return cudaGetLastError();
}

// One form, unweighted (om null) or fit-weighted.
template <bool EMIT, bool SCALE, bool CACHED>
cudaError_t launch_form(const float* tgt, const float* pj, const float* feat, const float* w,
                        const float* consts, const float* sd, const float* om, float* homog,
                        float* part, int J, int B, int F, int E, int Vt, int Vp,
                        int tiles_per_block, size_t smem, cudaStream_t stream) {
  if (om == nullptr)
    return launch_variant<EMIT, SCALE, CACHED, false>(tgt, pj, feat, w, consts, sd, om, homog,
                                                      part, J, B, F, E, Vt, Vp,
                                                      tiles_per_block, smem, stream);
  return launch_variant<EMIT, SCALE, CACHED, true>(tgt, pj, feat, w, consts, sd, om, homog,
                                                   part, J, B, F, E, Vt, Vp, tiles_per_block,
                                                   smem, stream);
}

}  // namespace

SMPL_API size_t rhs_moments_smem_bytes(int J, int E) {
  const int work = staging_floats() > TV * TB ? staging_floats() : TV * TB;
  return sizeof(float) * (12 * J * TB + J * TVP + 3 * E * TVP + work);
}

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F),
// sd (3, Vp, E), om null or the static fit weights (Vp, 1) -> r (E, B),
// y (3, J, B); homog (3, Vp, B) is written when
// emit_homog and read instead of feat and consts (which may be null) when
// cached; rt (E, B), yt (3, J, B), sc (3, B) when scale. emit_homog excludes
// scale and cached; unused outputs may be null. part is scratch of
// n_splits * R * B floats, R = rhs_rows(J, E, scale),
// n_splits = ceil(ceil(Vp / 64) / tiles_per_block). Requires E <= 32.
SMPL_API int rhs_moments_launch(const float* tgt, const float* pj, const float* feat,
                                const float* w, const float* consts, const float* sd,
                                const float* om, float* r_out, float* y, float* homog,
                                float* rt, float* yt, float* sc, float* part, int J, int B,
                                int F, int E, int Vt, int Vp, int tiles_per_block,
                                int emit_homog, int scale, int cached, cudaStream_t stream) {
  if ((emit_homog && (scale || cached)) || E > MAXE) return (int)cudaErrorInvalidValue;
  const size_t smem = rhs_moments_smem_bytes(J, E);
  float* h = (emit_homog || cached) ? homog : nullptr;
  cudaError_t err;
  if (emit_homog)
    err = launch_form<true, false, false>(tgt, pj, feat, w, consts, sd, om, h, part, J, B, F, E,
                                          Vt, Vp, tiles_per_block, smem, stream);
  else if (cached && scale)
    err = launch_form<false, true, true>(tgt, pj, feat, w, consts, sd, om, h, part, J, B, F, E,
                                         Vt, Vp, tiles_per_block, smem, stream);
  else if (cached)
    err = launch_form<false, false, true>(tgt, pj, feat, w, consts, sd, om, h, part, J, B, F, E,
                                          Vt, Vp, tiles_per_block, smem, stream);
  else if (scale)
    err = launch_form<false, true, false>(tgt, pj, feat, w, consts, sd, om, h, part, J, B, F, E,
                                          Vt, Vp, tiles_per_block, smem, stream);
  else
    err = launch_form<false, false, false>(tgt, pj, feat, w, consts, sd, om, h, part, J, B, F,
                                           E, Vt, Vp, tiles_per_block, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  const int R = rhs_rows(J, E, scale);
  const size_t n = (size_t)R * B;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  rhs_split_sum_kernel<<<blocks, threads, 0, stream>>>(part, y, r_out, yt, rt, sc, n_splits, J,
                                                       E, R, B);
  return (int)cudaGetLastError();
}
