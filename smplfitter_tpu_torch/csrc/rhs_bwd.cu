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
// K11 (feat, consts) folds dh into dfeat (F, B) = sum_c consts_c^T dh_c, as on
// the TPU; K12 (the cached template) writes dh (3, V_pad, B), which K7's
// backward (one GEMM) folds onto feat.
//
// What bounds it on an H100. K12: bytes. tgt and homog are read and dtgt and
// dh written once, 4 x 3 x V x B floats (2.06 GB at SMPL-X b4096, 0.62 ms at
// 3.35 TB/s), against 3E FMAs of G and about 27 per joint that skins the
// vertex (the blends of db, dh and pos, and the dpj fields) per (vertex,
// column). K11: f32 arithmetic, the posed template (3F, by K7) and dfeat's
// contraction (3F) per (vertex, column): at SMPL b4096 (F = 219) about 1.2 ms
// at the 67 TFLOP/s f32 peak.
//
// Design (bwd_front.cuh): a front kernel that walks the cover K2 walked
// (BlendSegments: segments of at most 32 vertices of one body part, each with
// its active joints; every vertex below `covers` once, covers >= V_t), a run
// of segments and 128 columns per block, a thread 4 vertices x 4 columns
// (lane = 4 tm + column group). gr is staged once per block and each
// segment's shape directions k-major by cp.async a segment ahead
// (template_tile.cuh), so G comes from the register-tiled shape dot. Per
// segment, over the segment's active joints only: pos from the template h
// (K12: the cached template; K11: K7's GEMM into a workspace) and b; db (the
// gy rows blended with [R|t]'s rotation applied to G, gy read through the
// cache), dtgt, and U = [gh] - Rbar^T db written at the segment's vertices
// (K12: dh; K11: over its template workspace, in place: each (vertex,
// column) is read once, by the thread that then writes it). b, h and -db are
// staged in shared memory, each thread its own, so that at most three 4 x 4
// x 3 fields are live in registers, and dpj sums both rank-1 fields, -db h
// and G b, in one warp reduce-scatter per joint and row pair into the run's
// partial (one owner lane per entry, bwd_front.cuh: add_dpj2). The runs are
// added in run order by split_sum_kernel. U's rows past the cover are gh
// (emit) or zero, as the dense sum has them. K11 then takes dfeat by the
// split-K GEMM over U (dfeat_gemm.cu). No atomics: a call repeats bit for
// bit.
#include "bwd_front.cuh"
#include "split_sum.cuh"

namespace {

using front::NT;
using front::TB;
using tmpl::SD_FLOATS;

// gr [MAXE][TB], two stages of shape directions, the threads' field stage.
constexpr size_t SMEM_BYTES =
    sizeof(float) * (tmpl::MAXE * TB + 2 * SD_FLOATS) + sizeof(float4) * front::STAGE_FLOAT4;
static_assert((tmpl::MAXE * TB + 2 * SD_FLOATS) % 4 == 0, "the field stage is float4-aligned");

// hsrc and U are one buffer in K11 (the front writes dh over its template),
// so neither is __restrict__.
template <bool VEC, bool W, bool GH>
__global__ void __launch_bounds__(NT, 1)
rhs_bwd_front(const float* __restrict__ gr, const float* __restrict__ gy,
              const float* __restrict__ gh, const float* __restrict__ tgt,
              const float* __restrict__ pj, const float* hsrc,
              const float* __restrict__ w, const float* __restrict__ sd,
              const float* __restrict__ om, const int* __restrict__ verts,
              const int* __restrict__ seg_offset, const int* __restrict__ joints,
              const int* __restrict__ joint_offset, float* __restrict__ dtgt, float* U,
              float* __restrict__ part, int J, int E, int B, int Vt,
              int Vp, int n_seg, int segs_per_run) {
  extern __shared__ float4 smem4[];
  float* const gr_s = reinterpret_cast<float*>(smem4);  // [E][TB]
  float* const sd_s = gr_s + tmpl::MAXE * TB;           // [2][3][E][SDL]
  float4* const stage = smem4 + (tmpl::MAXE * TB + 2 * SD_FLOATS) / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;             // vertex group: segment rows 4 tm .. 4 tm + 3
  const int tn = 4 * warp + lane % 4;  // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int s0 = blockIdx.y * segs_per_run;
  const int s1 = min(n_seg, s0 + segs_per_run);
  float* const part_run = part + (size_t)blockIdx.y * 12 * J * B;

  front::zero_dpj(part_run, J, B, bc, tm);
  tmpl::stage_columns(gr_s, gr, E, B, b0);
  if (s0 < s1) {
    const front::Tile tl = front::tile_at(seg_offset, nullptr, s0);
    tmpl::stage_shape_rows(sd_s, sd, verts + tl.beg, tl.n, E, Vp);
  }
  sgemm::cp_async_commit();

  for (int s = s0; s < s1; ++s) {
    const front::Tile tl = front::tile_at(seg_offset, nullptr, s);
    const int j0 = __ldg(joint_offset + s), nA = __ldg(joint_offset + s + 1) - j0;
    const int* const jl = joints + j0;
    int vid[4], vt[4];  // vt: the vertex where it has a target row, else -1
    front::tile_vertices(vid, verts, tl, tm);
    float om_v[4];  // ω, zero past the targets' rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vt[i] = vid[i] < Vt ? vid[i] : -1;
      om_v[i] = vt[i] >= 0 ? (W ? om[vt[i]] : 1.f) : 0.f;
    }

    // This segment's shape directions are in (and gr, on the first); the
    // other stage was last read by the previous segment, which every thread
    // has finished.
    sgemm::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < s1) {
      const front::Tile nx = front::tile_at(seg_offset, nullptr, s + 1);
      tmpl::stage_shape_rows(sd_s + ((s + 1 - s0) & 1) * SD_FLOATS, sd, verts + nx.beg, nx.n,
                             E, Vp);
    }
    sgemm::cp_async_commit();
    const float* const sd_t = sd_s + ((s - s0) & 1) * SD_FLOATS;

    // pos from the template (read before U may overwrite it); b = ω (tgt -
    // pos) and h staged.
    {
      float h[3][4][4], b[3][4][4];
      tmpl::load3<VEC>(h, hsrc, Vp, vid, B, bc);
      tmpl::blend_pos<VEC>(b, h, pj, w, jl, nA, J, B, bc, vid);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          if (vt[i] >= 0) tmpl::load4<VEC>(t4, tgt + ((size_t)a * Vt + vt[i]) * B + bc, bc, B);
#pragma unroll
          for (int k = 0; k < 4; ++k) b[a][i][k] = (t4[k] - b[a][i][k]) * om_v[i];
        }
      front::stage_field(stage, 1, b);
      front::stage_field(stage, 2, h);
    }
    float G[3][4][4];
    tmpl::zero(G);
    tmpl::add_shape_dot(G, sd_t, gr_s, E, tm, tn);
    // db = ω sum_j w_vj (gy[:, j] + R_j G); dtgt; U = [gh] - Rbar^T db; -db staged.
    {
      float db[3][4][4];
      tmpl::blend_affine<VEC>(db, G, pj, gy, J, w, jl, nA, J, B, bc, vid);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) db[a][i][k] *= om_v[i];
      tmpl::store3<VEC>(dtgt, Vt, db, vt, B, bc);
      {
        float u[3][4][4];
        tmpl::blend_project<VEC>(u, db, pj, w, jl, nA, J, B, bc, vid);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float g4[4] = {0.f, 0.f, 0.f, 0.f};
            if (GH && vid[i] >= 0)
              tmpl::load4<VEC>(g4, gh + ((size_t)c * Vp + vid[i]) * B + bc, bc, B);
#pragma unroll
            for (int k = 0; k < 4; ++k) u[c][i][k] = GH ? g4[k] - u[c][i][k] : -u[c][i][k];
          }
        tmpl::store3<VEC>(U, Vp, u, vid, B, bc);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) db[a][i][k] = -db[a][i][k];
      front::stage_field(stage, 0, db);
    }
    float h[3][4][4];
    front::staged_field(h, stage, 2);
    front::add_dpj2(part_run, stage, h, G, w, jl, nA, J, B, bc, vid, tm);
  }
  sgemm::cp_async_wait<0>();
}

template <bool VEC, bool W, bool GH>
cudaError_t launch_front(dim3 grid, cudaStream_t stream, const float* gr, const float* gy,
                         const float* gh, const float* tgt, const float* pj, const float* hsrc,
                         const float* w, const float* sd, const float* om, const int* verts,
                         const int* seg_offset, const int* joints, const int* joint_offset,
                         float* dtgt, float* U, float* part, int J, int E, int B, int Vt, int Vp,
                         int n_seg, int segs_per_run) {
  auto kernel = rhs_bwd_front<VEC, W, GH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(gr, gy, gh, tgt, pj, hsrc, w, sd, om, verts,
                                           seg_offset, joints, joint_offset, dtgt, U, part, J,
                                           E, B, Vt, Vp, n_seg, segs_per_run);
  return cudaGetLastError();
}

}  // namespace

// gr (E, B), gy (3, J, B), gh null or (3, Vp, B) (the emitted template's
// cotangent; K11 only), tgt (3, Vt, B), pj (12, J, B), w (Vp, J), sd
// (3, Vp, E), om null or the static fit weights (Vp, 1), the cover (verts,
// seg_offset (n_seg + 1), joints, joint_offset (n_seg + 1); every vertex
// below `covers` once, Vt <= covers <= Vp). K12: homog (3, Vp, B) the cached
// template, feat and consts null; -> dtgt (3, Vt, B), U = dh (3, Vp, B),
// out (12 J, B) = dpj. K11: homog null, feat (F, B), consts (>= 3, Vp, F); U
// (3, Vp, B) a workspace (the template, then dh); -> dtgt, out (12 J + F, B):
// dpj, then dfeat. part is scratch of n_runs * 12 J * B floats, n_runs =
// ceil(n_seg / segs_per_run), part_feat of feat_splits * F * B (null for one
// split). Requires 1 <= E <= 32.
SMPL_API int rhs_bwd_launch(const float* gr, const float* gy, const float* gh, const float* tgt,
                            const float* pj, const float* feat, const float* w,
                            const float* consts, const float* sd, const float* om,
                            const float* homog, const int* verts, const int* seg_offset,
                            const int* joints, const int* joint_offset, float* dtgt, float* U,
                            float* part, float* part_feat, float* out, int J, int B, int F,
                            int E, int Vt, int Vp, int n_seg, int covers, int segs_per_run,
                            int feat_splits, cudaStream_t stream) {
  const bool cached = homog != nullptr;
  if (E > tmpl::MAXE || E < 1 || n_seg < 1 || segs_per_run < 1 || covers < Vt || covers > Vp ||
      (cached && gh != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int err = 0;
  if (!cached) {
    err = posed_template_launch(feat, consts, U, F, B, Vp, stream);
    if (err != 0) return err;
  }
  const float* const hsrc = cached ? homog : U;
  if (covers < Vp) {  // U past the cover: gh, or zero
    const size_t pitch = sizeof(float) * (size_t)Vp * B;
    const size_t width = sizeof(float) * (size_t)(Vp - covers) * B;
    float* const past = U + (size_t)covers * B;
    err = gh != nullptr ? (int)cudaMemcpy2DAsync(past, pitch, gh + (size_t)covers * B, pitch,
                                                 width, 3, cudaMemcpyDeviceToDevice, stream)
                        : (int)cudaMemset2DAsync(past, pitch, 0, width, 3, stream);
    if (err != 0) return err;
  }
  const bool vec = B % 4 == 0 && sgemm::aligned16(gy) &&
                   (gh == nullptr || sgemm::aligned16(gh)) && sgemm::aligned16(tgt) &&
                   sgemm::aligned16(pj) && sgemm::aligned16(hsrc) && sgemm::aligned16(dtgt) &&
                   sgemm::aligned16(U);
  const int n_runs = (n_seg + segs_per_run - 1) / segs_per_run;
  const dim3 grid((B + TB - 1) / TB, n_runs);
#define K11_FRONT(v, wt, g)                                                                   \
  err = (int)launch_front<v, wt, g>(grid, stream, gr, gy, gh, tgt, pj, hsrc, w, sd, om,      \
                                    verts, seg_offset, joints, joint_offset, dtgt, U, part,  \
                                    J, E, B, Vt, Vp, n_seg, segs_per_run);
#define K11_FRONT_W(v, g) \
  if (om == nullptr) { K11_FRONT(v, false, g) } else { K11_FRONT(v, true, g) }
  if (vec) {
    if (gh != nullptr) { K11_FRONT_W(true, true) } else { K11_FRONT_W(true, false) }
  } else {
    if (gh != nullptr) { K11_FRONT_W(false, true) } else { K11_FRONT_W(false, false) }
  }
#undef K11_FRONT_W
#undef K11_FRONT
  if (err != 0) return err;
  err = (int)launch_split_sum(part, out, n_runs, (size_t)12 * J * B, stream);
  if (err != 0 || cached) return err;
  return dfeat_gemm_launch(consts, U, part_feat, out + (size_t)12 * J * B, F, B, Vp, feat_splits,
                           stream);
}
