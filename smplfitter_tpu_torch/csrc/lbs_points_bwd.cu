// K10: the backward pass of K1 (extended LBS -> points).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_lbs_points_bwd_kernel
// (launcher _lbs_points_bwd, shared body _lbs_grads_chunk; the VJP of
// lbs_points). For the points pos_a = sum_c blend_ac h_c + blend_a3 of K1
// (blend = the skinning-weighted [R|t], h_c = consts_c . feat, c = 0..2) and a
// cotangent g (3, V_pad, B):
//     dpj[a*4+c, j, b] = sum_v w_vj g_a h_c   (h_3 = 1)              (12, J, B)
//     dfeat[f, b]      = sum_c sum_v consts[c, v, f] (Rbar^T g)_c    (F, B)
// The 4th homogeneous channel is the constant 1 of the forward (K1 never reads
// consts[3]), so it adds nothing to dfeat.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column) the posed
// template and the dfeat contraction are 3F FMAs each, against 21 per joint
// that skins the vertex (Rbar^T g and the 12 dpj fields): at SMPL-X b4096 (F =
// 503, 3 joints per vertex) about 10475 * 4096 * (6 * 503 + 72) * 2 = 266
// GFLOP, 4.0 ms at the 67 TFLOP/s f32 peak; the operands' bytes take a tenth
// of that.
//
// Design (bwd_front.cuh): the template by K7's GEMM into a workspace H; a
// front kernel that walks the cover K1 walked (BlendSegments: segments of at
// most 32 vertices of one body part, each with its active joints; every
// vertex below `covers` once, every row with a nonzero weight among them),
// one segment per tile, a run of segments per block: it reads g and H at the
// tile's vertices, writes U = Rbar^T g there, and sums dpj over the
// segment's active joints into the run's partial; then dfeat by the split-K
// GEMM over U (dfeat_gemm.cu). Rows past the cover have zero weights, so they
// add nothing to either sum: U's are cleared by one 2D memset. No atomics: a
// call repeats bit for bit.
#include "bwd_front.cuh"
#include "split_sum.cuh"

namespace {

using front::NT;
using front::TB;

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
lbs_points_bwd_front(const float* __restrict__ g, const float* __restrict__ H,
                     const float* __restrict__ pj, const float* __restrict__ w,
                     const int* __restrict__ verts, const int* __restrict__ seg_offset,
                     const int* __restrict__ joints, const int* __restrict__ joint_offset,
                     float* __restrict__ U, float* __restrict__ part, int J, int B, int Vp,
                     int n_seg, int segs_per_run) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;             // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 4 * warp + lane % 4;  // column group: 4 tn .. 4 tn + 3
  const int bc = blockIdx.x * TB + 4 * tn;
  const int s0 = blockIdx.y * segs_per_run;
  const int s1 = min(n_seg, s0 + segs_per_run);
  float* const part_run = part + (size_t)blockIdx.y * 12 * J * B;

  front::zero_dpj(part_run, J, B, bc, tm);
  for (int s = s0; s < s1; ++s) {
    const front::Tile tl = front::tile_at(seg_offset, nullptr, s);
    const int j0 = __ldg(joint_offset + s), nA = __ldg(joint_offset + s + 1) - j0;
    int vid[4];
    front::tile_vertices(vid, verts, tl, tm);
    float gv[3][4][4];
    tmpl::load3<VEC>(gv, g, Vp, vid, B, bc);
    {
      float u[3][4][4];
      tmpl::blend_project<VEC>(u, gv, pj, w, joints + j0, nA, J, B, bc, vid);
      tmpl::store3<VEC>(U, Vp, u, vid, B, bc);
    }
    float h[3][4][4];
    tmpl::load3<VEC>(h, H, Vp, vid, B, bc);
    front::add_dpj(part_run, gv, h, w, joints + j0, nA, J, B, bc, vid, tm);
  }
}

}  // namespace

// g (3, Vp, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F),
// the cover (verts, seg_offset (n_seg + 1), joints, joint_offset (n_seg + 1);
// every vertex below `covers` once) -> out (12 J + F, B): rows [0, 12J) dpj
// (12, J, B), then dfeat (F, B). Workspaces: H and U (3, Vp, B), part (n_runs,
// 12 J, B) with n_runs = ceil(n_seg / segs_per_run), part_feat (feat_splits,
// F, B) (null for one split).
SMPL_API int lbs_points_bwd_launch(const float* g, const float* pj, const float* feat,
                                   const float* w, const float* consts, const int* verts,
                                   const int* seg_offset, const int* joints,
                                   const int* joint_offset, float* H, float* U, float* part,
                                   float* part_feat, float* out, int J, int B, int F, int Vp,
                                   int n_seg, int covers, int segs_per_run, int feat_splits,
                                   cudaStream_t stream) {
  if (segs_per_run < 1 || covers > Vp) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (n_seg == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)(12 * J + F) * B, stream);
  int err = posed_template_launch(feat, consts, H, F, B, Vp, stream);
  if (err != 0) return err;
  if (covers < Vp) {
    err = (int)cudaMemset2DAsync(U + (size_t)covers * B, sizeof(float) * (size_t)Vp * B, 0,
                                 sizeof(float) * (size_t)(Vp - covers) * B, 3, stream);
    if (err != 0) return err;
  }
  const bool vec = B % 4 == 0 && sgemm::aligned16(g) && sgemm::aligned16(H) &&
                   sgemm::aligned16(pj) && sgemm::aligned16(U);
  const int n_runs = (n_seg + segs_per_run - 1) / segs_per_run;
  const dim3 grid((B + TB - 1) / TB, n_runs);
  if (vec)
    lbs_points_bwd_front<true><<<grid, NT, 0, stream>>>(g, H, pj, w, verts, seg_offset, joints,
                                                        joint_offset, U, part, J, B, Vp, n_seg,
                                                        segs_per_run);
  else
    lbs_points_bwd_front<false><<<grid, NT, 0, stream>>>(g, H, pj, w, verts, seg_offset, joints,
                                                         joint_offset, U, part, J, B, Vp, n_seg,
                                                         segs_per_run);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = (int)launch_split_sum(part, out, n_runs, (size_t)12 * J * B, stream);
  if (err != 0) return err;
  return dfeat_gemm_launch(consts, U, part_feat, out + (size_t)12 * J * B, F, B, Vp,
                           feat_splits, stream);
}
