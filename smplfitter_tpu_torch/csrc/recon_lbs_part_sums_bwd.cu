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
// vertex outside every part contributes nothing (its dtgt rows are zero).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column) of a part:
// the template and the dfeat contraction (3F FMAs each), 24 per joint that
// skins the vertex (the blend, Rbar^T dpos and the dpj fields), and about 45
// for the position, dtgt, dpos and the dpj products: at SMPL-X b4096 (F = 503)
// about 3.6 ms at the 67 TFLOP/s f32 peak; the bytes take a tenth of that.
//
// Design (bwd_front.cuh): the template by K7's GEMM into a workspace H; a
// front kernel that walks the part index's tiles (PartIndex in
// ops/lbs_kernels.py: each part's vertex list in segments of at most 512, cut
// into tiles of 32, each segment with the joints that skin one of its
// vertices), a run of tiles per block. A tile's vertices share one part, so
// its 15 cotangent rows are read once per tile and column. Per tile: dpos from
// the targets, U = Rbar^T dpos at the tile's vertices, pos from H blended
// over the segment's joints, dtgt, and the dpj sums over those joints into
// the run's partial; each block also zeroes its share of the dtgt and U rows
// that no part holds. Then dfeat by the split-K GEMM over U (dfeat_gemm.cu).
// No atomics: a call repeats bit for bit.
#include "bwd_front.cuh"
#include "split_sum.cuh"

namespace {

using front::NT;
using front::TB;

template <bool VEC, bool W>
__global__ void __launch_bounds__(NT, 1)
recon_lbs_bwd_front(const float* __restrict__ graw, const float* __restrict__ gst,
                    const float* __restrict__ gsa, const float* __restrict__ tgt,
                    const float* __restrict__ pj, const float* __restrict__ H,
                    const float* __restrict__ w, const float* __restrict__ om,
                    const int* __restrict__ verts, const int* __restrict__ tile_offset,
                    const int* __restrict__ tile_seg, const int* __restrict__ joints,
                    const int* __restrict__ joint_offset, const int* __restrict__ vpart,
                    const int* __restrict__ unused, float* __restrict__ dtgt,
                    float* __restrict__ U, float* __restrict__ part, int J, int B, int Vt,
                    int Vp, int n_tiles, int n_unused, int tiles_per_run) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;             // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 4 * warp + lane % 4;  // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int t0 = blockIdx.y * tiles_per_run;
  const int t1 = min(n_tiles, t0 + tiles_per_run);
  float* const part_run = part + (size_t)blockIdx.y * 12 * J * B;

  front::zero_dpj(part_run, J, B, bc, tm);
  for (int t = t0; t < t1; ++t) {
    const front::Tile tl = front::tile_at(tile_offset, tile_seg, t);
    const int j0 = __ldg(joint_offset + tl.seg), nA = __ldg(joint_offset + tl.seg + 1) - j0;
    const int* const jl = joints + j0;
    int vid[4];
    front::tile_vertices(vid, verts, tl, tm);
    const int p = __ldg(vpart + __ldg(verts + tl.beg));  // the tile's part
    float om_v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) om_v[i] = W ? (vid[i] >= 0 && vid[i] < Vt ? om[vid[i]] : 0.f) : 1.f;
    // dpos from the targets and the part's cotangents, then U = Rbar^T dpos.
    float dpos[3][4][4];
    front::part_dpos<VEC>(dpos, graw, gsa, tgt, p, om_v, vid, J, B, Vt, bc);
    {
      float u[3][4][4];
      tmpl::blend_project<VEC>(u, dpos, pj, w, jl, nA, J, B, bc, vid);
      tmpl::store3<VEC>(U, Vp, u, vid, B, bc);
    }

    // dtgt from pos, blended from H.
    float h[3][4][4];
    tmpl::load3<VEC>(h, H, Vp, vid, B, bc);
    {
      float pos[3][4][4];
      tmpl::blend_pos<VEC>(pos, h, pj, w, jl, nA, J, B, bc, vid);
      front::store_dtgt<VEC>(dtgt, pos, graw, gst, p, om_v, vid, J, B, Vt, bc);
    }
    front::add_dpj(part_run, dpos, h, w, jl, nA, J, B, bc, vid, tm);
  }

  front::zero_unused<VEC>(dtgt, U, unused, n_unused, Vt, Vp, B, b0);
}

template <bool VEC, bool W>
cudaError_t launch_front(dim3 grid, cudaStream_t stream, const float* graw, const float* gst,
                         const float* gsa, const float* tgt, const float* pj, const float* H,
                         const float* w, const float* om, const int* verts,
                         const int* tile_offset, const int* tile_seg, const int* joints,
                         const int* joint_offset, const int* vpart, const int* unused,
                         float* dtgt, float* U, float* part, int J, int B, int Vt, int Vp,
                         int n_tiles, int n_unused, int tiles_per_run) {
  recon_lbs_bwd_front<VEC, W><<<grid, NT, 0, stream>>>(
      graw, gst, gsa, tgt, pj, H, w, om, verts, tile_offset, tile_seg, joints, joint_offset,
      vpart, unused, dtgt, U, part, J, B, Vt, Vp, n_tiles, n_unused, tiles_per_run);
  return cudaGetLastError();
}

}  // namespace

// graw (9, J, B), gst (3, J, B), gsa (3, J, B), tgt (3, Vt, B), pj (12, J, B),
// feat (F, B), w (Vp, J), consts (>= 3, Vp, F), om null or the static fit
// weights (Vp, 1), the part index's tiles (verts, tile_offset (n_tiles + 1),
// tile_seg (n_tiles), joints, joint_offset: each segment's active joints),
// vpart (Vp) each vertex's part or -1, unused (n_unused) the vertices below
// Vp in no part (with the tiles' vertices, every row below Vp once) -> dtgt
// (3, Vt, B), out (12 J + F, B): dpj (12, J, B) then dfeat (F, B).
// Workspaces: H and U (3, Vp, B), part (n_runs, 12 J, B) with n_runs =
// max(1, ceil(n_tiles / tiles_per_run)), part_feat (feat_splits, F, B)
// (null for one split).
SMPL_API int recon_lbs_bwd_launch(const float* graw, const float* gst, const float* gsa,
                                  const float* tgt, const float* pj, const float* feat,
                                  const float* w, const float* consts, const float* om,
                                  const int* verts, const int* tile_offset, const int* tile_seg,
                                  const int* joints, const int* joint_offset, const int* vpart,
                                  const int* unused, float* dtgt, float* H, float* U,
                                  float* part, float* part_feat, float* out, int J, int B,
                                  int F, int Vt, int Vp, int n_tiles, int n_unused,
                                  int tiles_per_run, int feat_splits, cudaStream_t stream) {
  if (tiles_per_run < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int err = 0;
  if (n_tiles > 0) {
    err = posed_template_launch(feat, consts, H, F, B, Vp, stream);
    if (err != 0) return err;
  }
  const bool vec = B % 4 == 0 && sgemm::aligned16(graw) && sgemm::aligned16(gst) &&
                   sgemm::aligned16(gsa) && sgemm::aligned16(tgt) && sgemm::aligned16(pj) &&
                   sgemm::aligned16(H) && sgemm::aligned16(U) && sgemm::aligned16(dtgt);
  const int n_runs = n_tiles > 0 ? (n_tiles + tiles_per_run - 1) / tiles_per_run : 1;
  const dim3 grid((B + TB - 1) / TB, n_runs);
#define K14_FRONT(v, wt)                                                                      \
  err = (int)launch_front<v, wt>(grid, stream, graw, gst, gsa, tgt, pj, H, w, om, verts,      \
                                 tile_offset, tile_seg, joints, joint_offset, vpart, unused,  \
                                 dtgt, U, part, J, B, Vt, Vp, n_tiles, n_unused, tiles_per_run);
  if (vec) {
    if (om == nullptr) { K14_FRONT(true, false) } else { K14_FRONT(true, true) }
  } else {
    if (om == nullptr) { K14_FRONT(false, false) } else { K14_FRONT(false, true) }
  }
#undef K14_FRONT
  if (err != 0) return err;
  err = (int)launch_split_sum(part, out, n_runs, (size_t)12 * J * B, stream);
  if (err != 0) return err;
  float* const dfeat = out + (size_t)12 * J * B;
  if (n_tiles == 0) return (int)cudaMemsetAsync(dfeat, 0, sizeof(float) * (size_t)F * B, stream);
  return dfeat_gemm_launch(consts, U, part_feat, dfeat, F, B, Vp, feat_splits, stream);
}
