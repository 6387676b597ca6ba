// K11 and K12: the backward passes of K2 (the residual moments of the shape
// solve), for its emit-homog, plain and cached forms.
//
// Replaces the TPU kernels smplfitter_tpu/ops/lbs_kernels.py:_rhs_bwd_kernel
// (K11, launcher _rhs_moments_bwd; the VJPs _rhs_moments_diff / _w_diff and,
// with the cotangent gh of the emitted template, _rhs_h_diff / _w_diff) and
// _rhs_cached_bwd_kernel (K12, launcher _rhs_cached_bwd; _rhs_c_diff /
// _w_diff). K2 computes, per vertex v < V_t and column b, the residual
// b = ω (tgt - pos) (ω = 1 without fit weights, zero past the targets' rows),
// r = sum_v SD_v^T Rbar_v^T b_v and y = sum_v w_vj b_v. With the cotangents gr
// (E, B) and gy (3, J, B), G_c = SD_v[c, :] . gr and
//     db_a   = ω (sum_j w_vj gy[a, j] + sum_c blend_ac G_c)          (per vertex)
//     dtgt_a = db_a                                                  (3, V_t, B)
//     dpj[a*4+c, j] = sum_v w_vj (-db_a h_c + G_c b_a)  (c < 3), sum_v w_vj (-db_a) (c = 3)
//     dh_c   = -sum_a blend_ac db_a [+ gh_c]                          (per vertex)
// K11 (feat, consts) folds dh into dfeat (F, B) = sum_c consts_c^T dh_c in the
// kernel, as on the TPU; K12 (the cached template) writes dh (3, V_pad, B),
// which K7's backward (one GEMM) folds onto feat.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): the posed
// template (3F, K11 only), the position and db (24J), the projection of db
// (9J), G (3E), 12 joint reductions (12J) and, in K11, 3 feature reductions
// (3F): at SMPL b4096 (F = 208, J = 24, E = 10) about 7168 * 4096 * 2200 * 2 =
// 130 GFLOP; at SMPL-X b4096 cached (J = 55, E = 16) about 10496 * 4096 * 2600
// * 2 = 220 GFLOP, against ~1.5 GB of traffic (targets, dtgt, homog, dh).
//
// Design: K2's tiles and the reductions of lbs_bwd.cuh. A block keeps its batch
// tile's [R|t] entries and gr in shared memory and walks the 64-vertex tiles
// of its vertex split. Per tile, db comes from one pass over the joints
// (folding the gy term and the blend into it, as pos_tile folds the blend into
// the position), so no blended transform is stored; gy is read through the
// cache. dtgt and dh are written once per vertex; dpj and dfeat go to the
// split's partials, summed in split order by split_sum_kernel. The fields are
// ordered so that at most four 4 x 4 x 3 arrays are live at once. Rows past
// the targets' (V_t) and past the batch edge are masked by global index.
#include "lbs_bwd.cuh"

using namespace lbs;
using namespace bwd;

namespace {

constexpr int MAXE = 32;

// G[c] = sum_e SD[c, v, e] gr[e, b] on the thread's micro-tile (sd_s: the
// tile's shape directions [3][E][TVP]; gr_s: the block's gr [E][TB]).
__device__ inline void sd_dot(float G[4][4], int c, const float* sd_s, const float* gr_s,
                              int E) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  zero4(G);
  for (int e = 0; e < E; ++e) {
    float s[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = sd_s[(c * E + e) * TVP + ty + 16 * i];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = gr_s[e * TB + tx + 16 * k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) G[i][k] = fmaf(s[i], q[k], G[i][k]);
  }
}

template <bool CACHED, bool GH, bool W>
__global__ void __launch_bounds__(NT, 1)
rhs_bwd_kernel(const float* __restrict__ gr, const float* __restrict__ gy,
               const float* __restrict__ gh, const float* __restrict__ tgt,
               const float* __restrict__ pj, const float* __restrict__ feat,
               const float* __restrict__ w, const float* __restrict__ consts,
               const float* __restrict__ sd, const float* __restrict__ om,
               const float* __restrict__ homog, float* __restrict__ dtgt,
               float* __restrict__ dh_out, float* __restrict__ part, int J, int B, int F, int E,
               int Vt, int Vp, int tiles_per_block) {
  extern __shared__ float smem[];
  float* pj_s = smem;                   // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;      // [J][TVP]
  float* sd_s = w_s + J * TVP;          // [3][E][TVP]
  float* gr_s = sd_s + 3 * E * TVP;     // [E][TB]
  float* work = gr_s + E * TB;          // work_floats()
  float* coef_s = work + work_floats(); // [ROWS][TVP] (K11 only)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB;
  const int R = 12 * J + (CACHED ? 0 : F);
  float* part_blk = part + (size_t)blockIdx.y * R * B;

  load_pj_tile(pj_s, pj, J, B, b0);
  for (int idx = threadIdx.x; idx < E * TB; idx += NT) {
    const int b = b0 + idx % TB;
    gr_s[idx] = b < B ? gr[(size_t)(idx / TB) * B + b] : 0.f;
  }
  zero_split(part_blk, R, B, b0);

  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, sd_s, work and coef_s
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    for (int idx = threadIdx.x; idx < TV * 3 * E; idx += NT) {
      const int ce = idx % (3 * E), vv = idx / (3 * E);
      const int v = v0 + vv;
      sd_s[ce * TVP + vv] = (v < Vp) ? sd[((size_t)(ce / E) * Vp + v) * E + ce % E] : 0.f;
    }
    __syncthreads();

    // db = ω (w . gy + blend . G), zero past the targets' rows and the batch.
    float db[3][4][4];
    {
      float G[3][4][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) sd_dot(G[c], c, sd_s, gr_s, E);
#pragma unroll
      for (int a = 0; a < 3; ++a) zero4(db[a]);
      for (int j = 0; j < J; ++j) {
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = w_s[j * TVP + ty + 16 * i];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = b0 + tx + 16 * k;
          float p[9], q[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            q[a] = b < B ? __ldg(&gy[((size_t)a * J + j) * B + b]) : 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) p[a * 3 + c] = pj_s[((a * 4 + c) * J + j) * TB + tx + 16 * k];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float s = fmaf(p[a * 3], G[0][i][k],
                              fmaf(p[a * 3 + 1], G[1][i][k],
                              fmaf(p[a * 3 + 2], G[2][i][k], q[a])));
              db[a][i][k] = fmaf(wv[i], s, db[a][i][k]);
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
      const float wv = v < Vt ? (W ? om[v] : 1.f) : 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) db[a][i][k] *= wv;
    }
    store_field(dtgt, db, Vt, Vt, v0, B, b0);

    // dh = -Rbar^T db [+ gh]: written (cached form) or folded onto feat.
    {
      float u[3][4][4];
      project_rbar(u, db, pj_s, w_s, J);
      float ghv[3][4][4];
      if (GH) load_field(ghv, gh, Vp, Vp, v0, B, b0);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) u[c][i][k] = GH ? ghv[c][i][k] - u[c][i][k] : -u[c][i][k];
      if (CACHED) {
        store_field(dh_out, u, Vp, Vp, v0, B, b0);
      } else {
        reduce_feat(part_blk, 12 * J, u, consts, F, Vp, v0, B, b0, work, coef_s);
      }
    }

    // The template and the weighted residual b = ω (tgt - pos).
    float h[3][4][4];
    if (CACHED) {
      load_field(h, homog, Vp, Vp, v0, B, b0);
    } else {
      homog_tile(h, feat, consts, F, B, Vp, rows, b0, work);
    }
    float res[3][4][4];
    pos_tile(res, h, pj_s, w_s, J);
    {
      float tv[3][4][4];
      load_field(tv, tgt, Vt, Vt, v0, B, b0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty + 16 * i;
        const float wv = v < Vt ? (W ? om[v] : 1.f) : 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) res[a][i][k] = (tv[a][i][k] - res[a][i][k]) * wv;
      }
    }

    // dpj: the blend enters through pos (-db h) and, in its rotation columns,
    // through Rbar^T b (G b). One G_c at a time.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float G[4][4];
      sd_dot(G, c, sd_s, gr_s, E);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            f[i][k] = fmaf(G[i][k], res[a][i][k], -db[a][i][k] * h[c][i][k]);
        reduce_joint_field(part_blk, (a * 4 + c) * J, f, w_s, work, J, B, b0);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) f[i][k] = -db[a][i][k];
      reduce_joint_field(part_blk, (a * 4 + 3) * J, f, w_s, work, J, B, b0);
    }
  }
}

template <bool CACHED, bool GH, bool W>
cudaError_t launch_variant(const float* gr, const float* gy, const float* gh, const float* tgt,
                           const float* pj, const float* feat, const float* w,
                           const float* consts, const float* sd, const float* om,
                           const float* homog, float* dtgt, float* dh, float* part, int J, int B,
                           int F, int E, int Vt, int Vp, int tiles_per_block, size_t smem,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rhs_bwd_kernel<CACHED, GH, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  dim3 grid((B + TB - 1) / TB, (n_vtiles + tiles_per_block - 1) / tiles_per_block);
  rhs_bwd_kernel<CACHED, GH, W><<<grid, NT, smem, stream>>>(
      gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog, dtgt, dh, part, J, B, F, E, Vt, Vp,
      tiles_per_block);
  return cudaGetLastError();
}

template <bool CACHED, bool GH>
cudaError_t launch_form(const float* gr, const float* gy, const float* gh, const float* tgt,
                        const float* pj, const float* feat, const float* w, const float* consts,
                        const float* sd, const float* om, const float* homog, float* dtgt,
                        float* dh, float* part, int J, int B, int F, int E, int Vt, int Vp,
                        int tiles_per_block, size_t smem, cudaStream_t stream) {
  if (om == nullptr)
    return launch_variant<CACHED, GH, false>(gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog,
                                             dtgt, dh, part, J, B, F, E, Vt, Vp,
                                             tiles_per_block, smem, stream);
  return launch_variant<CACHED, GH, true>(gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog,
                                          dtgt, dh, part, J, B, F, E, Vt, Vp, tiles_per_block,
                                          smem, stream);
}

}  // namespace

SMPL_API size_t rhs_bwd_smem_bytes(int J, int E, int cached) {
  return sizeof(float) * (12 * J * TB + J * TVP + 3 * E * TVP + E * TB + work_floats() +
                          (cached ? 0 : ROWS * TVP));
}

// gr (E, B), gy (3, J, B), gh null or (3, Vp, B) (the emitted template's
// cotangent; not with cached), tgt (3, Vt, B), pj (12, J, B), w (Vp, J),
// sd (3, Vp, E), om null or the static fit weights (Vp, 1); K11: feat (F, B)
// and consts (>= 3, Vp, F), homog null; K12 (cached): homog (3, Vp, B), feat
// and consts null. -> dtgt (3, Vt, B); K12: dh (3, Vp, B); out (12 J [+ F], B):
// dpj (12, J, B) [then dfeat (F, B)]. part is scratch of n_splits * (12 J [+ F])
// * B floats. Requires J <= 64, E <= 32.
SMPL_API int rhs_bwd_launch(const float* gr, const float* gy, const float* gh, const float* tgt,
                            const float* pj, const float* feat, const float* w,
                            const float* consts, const float* sd, const float* om,
                            const float* homog, float* dtgt, float* dh, float* out, float* part,
                            int J, int B, int F, int E, int Vt, int Vp, int tiles_per_block,
                            int cached, cudaStream_t stream) {
  if (J > ROWS || E > MAXE || (cached && gh != nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = rhs_bwd_smem_bytes(J, E, cached);
  cudaError_t err;
  if (cached)
    err = launch_form<true, false>(gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog, dtgt, dh,
                                   part, J, B, 0, E, Vt, Vp, tiles_per_block, smem, stream);
  else if (gh != nullptr)
    err = launch_form<false, true>(gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog, dtgt, dh,
                                   part, J, B, F, E, Vt, Vp, tiles_per_block, smem, stream);
  else
    err = launch_form<false, false>(gr, gy, gh, tgt, pj, feat, w, consts, sd, om, homog, dtgt,
                                    dh, part, J, B, F, E, Vt, Vp, tiles_per_block, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  const int R = 12 * J + (cached ? 0 : F);
  return (int)launch_split_sum(part, out, n_splits, (size_t)R * B, stream);
}
