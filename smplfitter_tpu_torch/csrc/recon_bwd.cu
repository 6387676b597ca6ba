// K13: the backward pass of K4 (the cached reconstruction fused into per-part
// sums).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_recon_cached_bwd_kernel
// (launcher _recon_cached_bwd; the VJPs _recon_cached_diff / _w_diff). K4
// computes, per vertex v and column, hfull = homog + SD_v x, pos = blended
// [R|t] . hfull, and with p(v) the vertex's body part the sums raw[c*3+d, p] of
// t_c pos_d ω, s_t[c, p] of t_c ω and s_a[d, p] of pos_d ω (ω = 1 without fit
// weights; with them the static column, zero past the targets' rows). With
// the cotangents graw (9, J, B), gst and gsa (3, J, B), read at the vertex's
// own part row (W = graw[:, p(v)]: the membership is one-hot, so this is a
// gather),
//     dtgt_c = ω (gst[c, p] + sum_d W[c*3+d] pos_d)                  (3, V_t, B)
//     dpos_d = ω (gsa[d, p] + sum_c W[c*3+d] t_c)
//     dh_c   = (Rbar^T dpos)_c                                        (3, V_pad, B)
//     dx[e]  = sum_v sum_c SD_v[c, e] dh_c                            (E, B)
//     dpj[a*4+c, j] = sum_v w_vj dpos_a hfull_c  (hfull_3 = 1)         (12, J, B)
// A vertex outside every part contributes nothing (its dtgt and dh rows are
// zero). dh is the cotangent of the cached template; K2's and K7's backward
// passes fold it onto their inputs.
//
// What bounds it on an H100: bytes. tgt and homog are read and dtgt and dh
// written once, 4 x 3 x V x B floats (2.06 GB at SMPL-X b4096, 0.62 ms at
// 3.35 TB/s), against 24 FMAs per joint that skins the vertex (the blend and
// the dpj fields), 6E (SD x and dx) and about 45 more per (vertex, column).
//
// Design: K14's front (bwd_front.cuh) over the part index's tiles (PartIndex
// in ops/lbs_kernels.py: each part's vertex list in segments of at most 512,
// cut into tiles of 32, each segment with the joints that skin one of its
// vertices), a run of tiles and 128 columns per block, a thread 4 vertices x
// 4 columns (lane = 4 tm + column group: a warp holds the tile's 32 vertices
// of 16 columns). There is no template GEMM: hfull is the cached template
// plus SD x (template_tile.cuh: x staged once per block, the tile's shape
// directions k-major in one of two shared stages, the next tile's copied by
// cp.async under this one). A tile's vertices share one part, so its 15
// cotangent rows are read once per tile and column. Per tile: dpos, dh =
// Rbar^T dpos over the segment's joints (written out), dx by the warp
// reduce-scatter of SD^T dh (one owner lane per (e, column), in registers
// over the run), pos and dtgt, and the dpj sums over the segment's joints
// into the run's partial; the run's dx goes into its partial after dpj's 12J
// rows, and split_sum_kernel adds the runs in run order. Each block also
// zeroes its share of the dtgt and dh rows that no part holds. No atomics: a
// call repeats bit for bit.
#include "bwd_front.cuh"
#include "split_sum.cuh"

namespace {

using front::NT;
using front::TB;
using tmpl::EP;
using tmpl::SD_FLOATS;

// x [MAXE][TB], then two stages of shape directions.
constexpr size_t SMEM_BYTES = sizeof(float) * (tmpl::MAXE * TB + 2 * SD_FLOATS);

template <bool VEC, bool W>
__global__ void __launch_bounds__(NT, 1)
recon_cached_bwd_front(const float* __restrict__ graw, const float* __restrict__ gst,
                       const float* __restrict__ gsa, const float* __restrict__ tgt,
                       const float* __restrict__ pj, const float* __restrict__ x,
                       const float* __restrict__ sd, const float* __restrict__ homog,
                       const float* __restrict__ w, const float* __restrict__ om,
                       const int* __restrict__ verts, const int* __restrict__ tile_offset,
                       const int* __restrict__ tile_seg, const int* __restrict__ joints,
                       const int* __restrict__ joint_offset, const int* __restrict__ vpart,
                       const int* __restrict__ unused, float* __restrict__ dtgt,
                       float* __restrict__ dh, float* __restrict__ part, int J, int E, int B,
                       int Vt, int Vp, int n_tiles, int n_unused, int tiles_per_run) {
  extern __shared__ float4 smem4[];
  float* const x_s = reinterpret_cast<float*>(smem4);  // [E][TB]
  float* const sd_s = x_s + tmpl::MAXE * TB;           // [2][3][E][SDL]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;             // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 4 * warp + lane % 4;  // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int t0 = blockIdx.y * tiles_per_run;
  const int t1 = min(n_tiles, t0 + tiles_per_run);
  float* const part_run = part + (size_t)blockIdx.y * (12 * J + E) * B;

  front::zero_dpj(part_run, J, B, bc, tm);
  tmpl::stage_columns(x_s, x, E, B, b0);
  if (t0 < t1) {
    const front::Tile tl = front::tile_at(tile_offset, tile_seg, t0);
    tmpl::stage_shape_rows(sd_s, sd, verts + tl.beg, tl.n, E, Vp);
  }
  sgemm::cp_async_commit();

  float dx[EP];
#pragma unroll
  for (int q = 0; q < EP; ++q) dx[q] = 0.f;

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
    float h[3][4][4], dpos[3][4][4];
    tmpl::load3<VEC>(h, homog, Vp, vid, B, bc);
    front::part_dpos<VEC>(dpos, graw, gsa, tgt, p, om_v, vid, J, B, Vt, bc);

    // This tile's shape directions are in (and x, on the first tile); the
    // other stage was last read by the previous tile, which every thread has
    // finished.
    sgemm::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < t1) {
      const front::Tile nx = front::tile_at(tile_offset, tile_seg, t + 1);
      tmpl::stage_shape_rows(sd_s + ((t + 1 - t0) & 1) * SD_FLOATS, sd, verts + nx.beg, nx.n,
                             E, Vp);
    }
    sgemm::cp_async_commit();
    const float* const sd_t = sd_s + ((t - t0) & 1) * SD_FLOATS;
    tmpl::add_shape_dot(h, sd_t, x_s, E, tm, tn);  // h: hfull

    // dh = Rbar^T dpos, written out and reduced onto dx.
    {
      float u[3][4][4];
      tmpl::blend_project<VEC>(u, dpos, pj, w, jl, nA, J, B, bc, vid);
      tmpl::store3<VEC>(dh, Vp, u, vid, B, bc);
      tmpl::add_shape_rows(dx, u, sd_t, E, tm);
    }
    // dtgt from pos, blended from hfull.
    {
      float pos[3][4][4];
      tmpl::blend_pos<VEC>(pos, h, pj, w, jl, nA, J, B, bc, vid);
      front::store_dtgt<VEC>(dtgt, pos, graw, gst, p, om_v, vid, J, B, Vt, bc);
    }
    front::add_dpj(part_run, dpos, h, w, jl, nA, J, B, bc, vid, tm);
  }
  sgemm::cp_async_wait<0>();

  // The lane's own dx entries: rows 12 J + 2q + tm / 4, column bc + tm % 4.
  const int col = bc + (tm & 3);
  if (col < B) {
#pragma unroll
    for (int q = 0; q < EP; ++q) {
      const int e = 2 * q + tm / 4;
      if (e < E) part_run[(size_t)(12 * J + e) * B + col] = dx[q];
    }
  }
  front::zero_unused<VEC>(dtgt, dh, unused, n_unused, Vt, Vp, B, b0);
}

template <bool VEC, bool W>
cudaError_t launch_front(dim3 grid, cudaStream_t stream, const float* graw, const float* gst,
                         const float* gsa, const float* tgt, const float* pj, const float* x,
                         const float* sd, const float* homog, const float* w, const float* om,
                         const int* verts, const int* tile_offset, const int* tile_seg,
                         const int* joints, const int* joint_offset, const int* vpart,
                         const int* unused, float* dtgt, float* dh, float* part, int J, int E,
                         int B, int Vt, int Vp, int n_tiles, int n_unused, int tiles_per_run) {
  recon_cached_bwd_front<VEC, W><<<grid, NT, SMEM_BYTES, stream>>>(
      graw, gst, gsa, tgt, pj, x, sd, homog, w, om, verts, tile_offset, tile_seg, joints,
      joint_offset, vpart, unused, dtgt, dh, part, J, E, B, Vt, Vp, n_tiles, n_unused,
      tiles_per_run);
  return cudaGetLastError();
}

}  // namespace

// graw (9, J, B), gst (3, J, B), gsa (3, J, B), tgt (3, Vt, B), pj (12, J, B),
// x (E, B), sd (3, Vp, E), homog (3, Vp, B), w (Vp, J), om null or the static
// fit weights (Vp, 1), the part index's tiles (verts, tile_offset
// (n_tiles + 1), tile_seg (n_tiles), joints, joint_offset: each segment's
// active joints), vpart (Vp) each vertex's part or -1, unused (n_unused) the
// vertices below Vp in no part (with the tiles' vertices, every row below Vp
// once) -> dtgt (3, Vt, B), dh (3, Vp, B), out (12 J + E, B): dpj (12, J, B)
// then dx (E, B). part is scratch of n_runs * (12 J + E) * B floats, n_runs =
// max(1, ceil(n_tiles / tiles_per_run)). Requires E <= 32.
SMPL_API int recon_bwd_launch(const float* graw, const float* gst, const float* gsa,
                              const float* tgt, const float* pj, const float* x, const float* sd,
                              const float* homog, const float* w, const float* om,
                              const int* verts, const int* tile_offset, const int* tile_seg,
                              const int* joints, const int* joint_offset, const int* vpart,
                              const int* unused, float* dtgt, float* dh, float* out, float* part,
                              int J, int E, int B, int Vt, int Vp, int n_tiles, int n_unused,
                              int tiles_per_run, cudaStream_t stream) {
  if (E > tmpl::MAXE || E < 0 || tiles_per_run < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const bool vec = B % 4 == 0 && sgemm::aligned16(graw) && sgemm::aligned16(gst) &&
                   sgemm::aligned16(gsa) && sgemm::aligned16(tgt) && sgemm::aligned16(pj) &&
                   sgemm::aligned16(homog) && sgemm::aligned16(dh) && sgemm::aligned16(dtgt);
  const int n_runs = n_tiles > 0 ? (n_tiles + tiles_per_run - 1) / tiles_per_run : 1;
  const dim3 grid((B + TB - 1) / TB, n_runs);
  int err = 0;
#define K13_FRONT(v, wt)                                                                       \
  err = (int)launch_front<v, wt>(grid, stream, graw, gst, gsa, tgt, pj, x, sd, homog, w, om,  \
                                 verts, tile_offset, tile_seg, joints, joint_offset, vpart,   \
                                 unused, dtgt, dh, part, J, E, B, Vt, Vp, n_tiles, n_unused,  \
                                 tiles_per_run);
  if (vec) {
    if (om == nullptr) { K13_FRONT(true, false) } else { K13_FRONT(true, true) }
  } else {
    if (om == nullptr) { K13_FRONT(false, false) } else { K13_FRONT(false, true) }
  }
#undef K13_FRONT
  if (err != 0) return err;
  return (int)launch_split_sum(part, out, n_runs, (size_t)(12 * J + E) * B, stream);
}
