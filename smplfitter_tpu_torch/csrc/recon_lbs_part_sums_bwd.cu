// K14: the backward pass of K6 (reconstruction by extended LBS fused into
// per-part sums).
//
// Replaces the TPU kernel
// smplfitter_tpu/ops/lbs_kernels.py:_recon_part_sums_bwd_kernel (launcher
// _recon_part_sums_bwd; the VJPs _recon_part_sums_diff / _w_diff). K6
// computes, per vertex v and column, the posed template h_c = consts_c . feat
// (c = 0..2), pos = blended [R|t] . h, and with p(v) the vertex's body part
// the sums raw[c*3+d, p] of t_c pos_d ω, s_t[c, p] of t_c ω and s_a[d, p] of
// pos_d ω (ω = 1 without fit weights; with them the static column, zero past
// the targets' rows). With the cotangents graw (9, J, B), gst and gsa
// (3, J, B), read at the vertex's own part row (W = graw[:, p(v)]: the
// membership is one-hot, so this is a gather),
//     dtgt_c = ω (gst[c, p] + sum_d W[c*3+d] pos_d)                (3, V_t, B)
//     dpos_d = ω (gsa[d, p] + sum_c W[c*3+d] t_c)
// and dpos goes through K1's backward (K10):
//     dpj[a*4+c, j] = sum_v w_vj dpos_a h_c  (h_3 = 1)                (12, J, B)
//     dfeat[f]      = sum_c sum_v consts[c, v, f] (Rbar^T dpos)_c     (F, B)
// The homogeneous channel 3 is K6's constant 1 and adds nothing to dfeat. A
// vertex outside every part contributes nothing.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): the
// template (3F FMAs), the blended [R|t] (12J), the position and Rbar^T dpos
// (18), dtgt and dpos from the part's cotangents (18), the dpj products (9),
// the 12 dpj fields reduced over the joints (12J) and the 3 template fields
// over the features (3F): at SMPL b4096 (F = 219, J = 24) about 6890 * 4096 *
// 1935 * 2 = 109 GFLOP against ~0.5 GB of traffic.
//
// Design: K13's front (recon_bwd.cu: the part gather, dtgt and dpos on K2's
// vertex tiles) on K10's body (lbs_points_bwd.cu: the template recomputed
// per tile, the dpj and dfeat reductions of lbs_bwd.cuh into per-split
// partials, added in split order by split_sum_kernel; no atomics). The F
// contraction stays in the kernel, as on the TPU: neither the mesh nor
// Rbar^T dpos reaches device memory. Vertex and batch edges are masked by
// global index.
#include "lbs_bwd.cuh"

using namespace lbs;
using namespace bwd;

namespace {

template <bool W>
__global__ void __launch_bounds__(NT, 1)
recon_lbs_bwd_kernel(const float* __restrict__ graw, const float* __restrict__ gst,
                     const float* __restrict__ gsa, const float* __restrict__ tgt,
                     const float* __restrict__ pj, const float* __restrict__ feat,
                     const float* __restrict__ w, const float* __restrict__ consts,
                     const float* __restrict__ om, const int* __restrict__ vpart,
                     float* __restrict__ dtgt, float* __restrict__ part, int J, int B, int F,
                     int Vt, int Vp, int tiles_per_block) {
  extern __shared__ float smem[];
  float* pj_s = smem;                    // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;       // [J][TVP]
  float* work = w_s + J * TVP;           // work_floats()
  float* coef_s = work + work_floats();  // [ROWS][TVP]
  int* part_s = reinterpret_cast<int*>(coef_s + ROWS * TVP);  // [TV]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB;
  const int R = 12 * J + F;
  float* part_blk = part + (size_t)blockIdx.y * R * B;

  load_pj_tile(pj_s, pj, J, B, b0);
  zero_split(part_blk, R, B, b0);
  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, part_s, work and coef_s
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    for (int vv = threadIdx.x; vv < TV; vv += NT) part_s[vv] = v0 + vv < Vp ? vpart[v0 + vv] : -1;
    float h[3][4][4];
    homog_tile(h, feat, consts, F, B, Vp, rows, b0, work);  // its barriers publish w_s, part_s

    // dtgt and dpos from the cotangents of the vertex's part.
    float dpos[3][4][4];
    {
      float pos[3][4][4];
      pos_tile(pos, h, pj_s, w_s, J);
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

    // dpj: dpos times the template (channel 3 is 1), reduced over the joints.
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) f[i][k] = dpos[a][i][k] * (c < 3 ? h[c % 3][i][k] : 1.f);
        reduce_joint_field(part_blk, (a * 4 + c) * J, f, w_s, work, J, B, b0);
      }

    // dfeat: Rbar^T dpos reduced over the features.
    float u[3][4][4];
    project_rbar(u, dpos, pj_s, w_s, J);
    reduce_feat(part_blk, 12 * J, u, consts, F, Vp, v0, B, b0, work, coef_s);
  }
}

template <bool W>
cudaError_t launch_variant(const float* graw, const float* gst, const float* gsa,
                           const float* tgt, const float* pj, const float* feat, const float* w,
                           const float* consts, const float* om, const int* vpart, float* dtgt,
                           float* part, int J, int B, int F, int Vt, int Vp, int tiles_per_block,
                           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(recon_lbs_bwd_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  dim3 grid((B + TB - 1) / TB, (n_vtiles + tiles_per_block - 1) / tiles_per_block);
  recon_lbs_bwd_kernel<W><<<grid, NT, smem, stream>>>(graw, gst, gsa, tgt, pj, feat, w, consts,
                                                      om, vpart, dtgt, part, J, B, F, Vt, Vp,
                                                      tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

SMPL_API size_t recon_lbs_bwd_smem_bytes(int J) {
  return sizeof(float) * (12 * J * TB + J * TVP + work_floats() + ROWS * TVP) +
         sizeof(int) * TV;
}

// graw (9, J, B), gst (3, J, B), gsa (3, J, B), tgt (3, Vt, B), pj (12, J, B),
// feat (F, B), w (Vp, J), consts (>= 3, Vp, F), om null or the static fit
// weights (Vp, 1), vpart (Vp) int32: each vertex's part or -1 -> dtgt
// (3, Vt, B), out (12 J + F, B): dpj (12, J, B) then dfeat (F, B). part is
// scratch of n_splits * (12 J + F) * B floats, n_splits = ceil(ceil(Vp / 64) /
// tiles_per_block). Requires J <= 64.
SMPL_API int recon_lbs_bwd_launch(const float* graw, const float* gst, const float* gsa,
                                  const float* tgt, const float* pj, const float* feat,
                                  const float* w, const float* consts, const float* om,
                                  const int* vpart, float* dtgt, float* out, float* part, int J,
                                  int B, int F, int Vt, int Vp, int tiles_per_block,
                                  cudaStream_t stream) {
  if (J > ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = recon_lbs_bwd_smem_bytes(J);
  const cudaError_t err =
      om == nullptr
          ? launch_variant<false>(graw, gst, gsa, tgt, pj, feat, w, consts, om, vpart, dtgt,
                                  part, J, B, F, Vt, Vp, tiles_per_block, smem, stream)
          : launch_variant<true>(graw, gst, gsa, tgt, pj, feat, w, consts, om, vpart, dtgt,
                                 part, J, B, F, Vt, Vp, tiles_per_block, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  return (int)launch_split_sum(part, out, n_splits, (size_t)(12 * J + F) * B, stream);
}
