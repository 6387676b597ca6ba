// K13: the backward pass of K4 (the cached reconstruction fused into per-part
// sums).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_recon_cached_bwd_kernel
// (launcher _recon_cached_bwd; the VJPs _recon_cached_diff / _w_diff). K4
// computes, per vertex v and column, hfull = homog + SD_v x, pos = blended
// [R|t] . hfull, and with p(v) the vertex's body part the sums raw[c*3+d, p] of
// t_c pos_d ω, s_t[c, p] of t_c ω and s_a[d, p] of pos_d ω (ω = 1 without fit
// weights; with them zero past the targets' rows). With the cotangents graw
// (9, J, B), gst and gsa (3, J, B), read at the vertex's own part row
// (W = graw[:, p(v)]: the membership is one-hot, so the per-vertex weight of
// the part sums is a gather, no product over the joints),
//     dtgt_c = ω (gst[c, p] + sum_d W[c*3+d] pos_d)                  (3, V_t, B)
//     dpos_d = ω (gsa[d, p] + sum_c W[c*3+d] t_c)
//     dh_c   = sum_a blend_ac dpos_a                                  (3, V_pad, B)
//     dx[e]  = sum_v sum_c SD_v[c, e] dh_c                            (E, B)
//     dpj[a*4+c, j] = sum_v w_vj dpos_a hfull_c  (hfull_3 = 1)         (12, J, B)
// A vertex outside every part contributes nothing. dh is the cotangent of the
// cached template; K2's and K7's backward passes fold it onto their inputs.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): SD x (3E),
// the position (12J), the projection of dpos (9J), 12 joint reductions (12J)
// and 3 shape reductions (3E): at SMPL b4096 (J = 24, E = 10) about 7168 * 4096
// * 880 * 2 = 52 GFLOP; the 15 gathered cotangents per (vertex, column) come
// through the cache (the block's slice is 15 J 64 floats).
//
// Design: K2's vertex tiles (lbs_tile.cuh) rather than K4's part segments: the
// dpj reduction spans all parts, and per-segment partials of (12 J + E) rows
// would be n_seg times larger than per-split ones. Each vertex's part comes
// from a per-vertex index (-1 for none). dtgt and dh are written once per
// vertex; dpj and dx go to the split's partials, summed in split order.
#include "lbs_bwd.cuh"

using namespace lbs;
using namespace bwd;

namespace {

constexpr int MAXE = 32;

template <bool W>
__global__ void __launch_bounds__(NT, 1)
recon_bwd_kernel(const float* __restrict__ graw, const float* __restrict__ gst,
                 const float* __restrict__ gsa, const float* __restrict__ tgt,
                 const float* __restrict__ pj, const float* __restrict__ x,
                 const float* __restrict__ sd, const float* __restrict__ homog,
                 const float* __restrict__ w, const float* __restrict__ om,
                 const int* __restrict__ vpart, float* __restrict__ dtgt,
                 float* __restrict__ dh_out, float* __restrict__ part, int J, int E, int B,
                 int Vt, int Vp, int tiles_per_block) {
  extern __shared__ float smem[];
  float* pj_s = smem;                  // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;     // [J][TVP]
  float* sd_s = w_s + J * TVP;         // [3][E][TVP]
  float* x_s = sd_s + 3 * E * TVP;     // [E][TB]
  float* work = x_s + E * TB;          // [TV][TB]
  int* part_s = reinterpret_cast<int*>(work + TV * TB);  // [TV]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB;
  const int R = 12 * J + E;
  float* part_blk = part + (size_t)blockIdx.y * R * B;

  load_pj_tile(pj_s, pj, J, B, b0);
  for (int idx = threadIdx.x; idx < E * TB; idx += NT) {
    const int b = b0 + idx % TB;
    x_s[idx] = b < B ? x[(size_t)(idx / TB) * B + b] : 0.f;
  }
  zero_split(part_blk, R, B, b0);

  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, sd_s, part_s and work
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    for (int idx = threadIdx.x; idx < TV * 3 * E; idx += NT) {
      const int ce = idx % (3 * E), vv = idx / (3 * E);
      const int v = v0 + vv;
      sd_s[ce * TVP + vv] = (v < Vp) ? sd[((size_t)(ce / E) * Vp + v) * E + ce % E] : 0.f;
    }
    for (int vv = threadIdx.x; vv < TV; vv += NT) part_s[vv] = v0 + vv < Vp ? vpart[v0 + vv] : -1;
    __syncthreads();

    // hfull = homog + SD x.
    float hf[3][4][4];
    load_field(hf, homog, Vp, Vp, v0, B, b0);
    for (int e = 0; e < E; ++e) {
      float xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = x_s[e * TB + tx + 16 * k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = sd_s[(c * E + e) * TVP + ty + 16 * i];
#pragma unroll
          for (int k = 0; k < 4; ++k) hf[c][i][k] = fmaf(s, xv[k], hf[c][i][k]);
        }
    }

    // dtgt and dpos from the cotangents of the vertex's part.
    float dpos[3][4][4];
    {
      float pos[3][4][4];
      pos_tile(pos, hf, pj_s, w_s, J);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty + 16 * i;
        const int p = part_s[ty + 16 * i];
        const float wv = W ? (v < Vt ? om[v] : 0.f) : 1.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = b0 + tx + 16 * k;
          float dt[3] = {0.f, 0.f, 0.f}, dp[3] = {0.f, 0.f, 0.f};
          if (p >= 0 && b < B) {
            float tc[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) tc[c] = v < Vt ? tgt[((size_t)c * Vt + v) * B + b] : 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              dt[c] = __ldg(&gst[((size_t)c * J + p) * B + b]);
              dp[c] = __ldg(&gsa[((size_t)c * J + p) * B + b]);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                const float wcd = __ldg(&graw[((size_t)(c * 3 + d) * J + p) * B + b]);
                dt[c] = fmaf(wcd, pos[d][i][k], dt[c]);
                dp[d] = fmaf(wcd, tc[c], dp[d]);
              }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (v < Vt && b < B) dtgt[((size_t)c * Vt + v) * B + b] = dt[c] * wv;
            dpos[c][i][k] = dp[c] * wv;
          }
        }
      }
    }

    // dh = Rbar^T dpos, written per vertex and reduced onto dx.
    {
      float dh[3][4][4];
      project_rbar(dh, dpos, pj_s, w_s, J);
      store_field(dh_out, dh, Vp, Vp, v0, B, b0);
      float acc[4][4];
      zero4(acc);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        stage_coord(work, dh[c]);
        rows_dot(acc, sd_s + c * E * TVP, work, E);
        __syncthreads();
      }
      flush_rows(part_blk, 12 * J, acc, E, B, b0);
    }

    // dpj: the blend applied to hfull (channel 3 is 1).
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            f[i][k] = dpos[a][i][k] * (c < 3 ? hf[c % 3][i][k] : 1.f);
        reduce_joint_field(part_blk, (a * 4 + c) * J, f, w_s, work, J, B, b0);
      }
  }
}

template <bool W>
cudaError_t launch_variant(const float* graw, const float* gst, const float* gsa,
                           const float* tgt, const float* pj, const float* x, const float* sd,
                           const float* homog, const float* w, const float* om,
                           const int* vpart, float* dtgt, float* dh, float* part, int J, int E,
                           int B, int Vt, int Vp, int tiles_per_block, size_t smem,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(recon_bwd_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  dim3 grid((B + TB - 1) / TB, (n_vtiles + tiles_per_block - 1) / tiles_per_block);
  recon_bwd_kernel<W><<<grid, NT, smem, stream>>>(graw, gst, gsa, tgt, pj, x, sd, homog, w, om,
                                                  vpart, dtgt, dh, part, J, E, B, Vt, Vp,
                                                  tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

SMPL_API size_t recon_bwd_smem_bytes(int J, int E) {
  return sizeof(float) * (12 * J * TB + J * TVP + 3 * E * TVP + E * TB + TV * TB) +
         sizeof(int) * TV;
}

// graw (9, J, B), gst (3, J, B), gsa (3, J, B), tgt (3, Vt, B), pj (12, J, B),
// x (E, B), sd (3, Vp, E), homog (3, Vp, B), w (Vp, J), om null or the static
// fit weights (Vp, 1), vpart (Vp) int32: each vertex's part or -1 -> dtgt
// (3, Vt, B), dh (3, Vp, B), out (12 J + E, B): dpj (12, J, B) then dx (E, B).
// part is scratch of n_splits * (12 J + E) * B floats. Requires J <= 64, E <= 32.
SMPL_API int recon_bwd_launch(const float* graw, const float* gst, const float* gsa,
                              const float* tgt, const float* pj, const float* x, const float* sd,
                              const float* homog, const float* w, const float* om,
                              const int* vpart, float* dtgt, float* dh, float* out, float* part,
                              int J, int E, int B, int Vt, int Vp, int tiles_per_block,
                              cudaStream_t stream) {
  if (J > ROWS || E > MAXE) return (int)cudaErrorInvalidValue;
  const size_t smem = recon_bwd_smem_bytes(J, E);
  const cudaError_t err =
      om == nullptr
          ? launch_variant<false>(graw, gst, gsa, tgt, pj, x, sd, homog, w, om, vpart, dtgt, dh,
                                  part, J, E, B, Vt, Vp, tiles_per_block, smem, stream)
          : launch_variant<true>(graw, gst, gsa, tgt, pj, x, sd, homog, w, om, vpart, dtgt, dh,
                                 part, J, E, B, Vt, Vp, tiles_per_block, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  return (int)launch_split_sum(part, out, n_splits, (size_t)(12 * J + E) * B, stream);
}
