// K4: reconstruction from the cached posed template, fused into per-part sums.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_recon_cached_kernel
// (launcher _recon_cached_impl, API recon_part_sums_cached_lm). Per vertex v
// and batch column: hfull_c = homog_c + SD_v[c, :] . x, pos = blended [R|t] .
// hfull, and with p(v) the vertex's body part (one-hot membership pm),
//     raw[c*3+d, p, :] += t_c pos_d,  s_t[c, p, :] += t_c,  s_a[d, p, :] += pos_d.
// The fit-weighted form (W) multiplies pos by ω in every sum and t by ω in
// s_t, ω the static column (V_pad, 1) or per-call weights (V, B), read
// through a row and a batch stride (part_segments.cuh:fit_weight).
//
// What bounds it on an H100: bytes. The cached template and the targets are
// read once, 2 x 3 x V x B floats (1.03 GB at SMPL-X b4096, 0.31 ms at
// 3.35 TB/s), against 3E + 12 per joint that skins the vertex + 15 FMAs per
// (vertex, column) (about 0.1 ms of the f32 peak at SMPL-X).
//
// Design: K6 (recon_lbs_part_sums.cu) with its template dot replaced by the
// cached template plus SD x. A block owns (segment of one part's vertex
// list, 128 batch columns) and walks the segment in tiles of 32 listed
// vertices, a thread 4 vertices x 4 columns (template_tile.cuh's layout):
// - the template: homog read as float4 per (vertex, channel), plus SD x as a
//   register-tiled dot from shared memory: x (E, 128 columns) staged once per
//   block, the tile's shape directions k-major, copied by cp.async into one
//   of two stages while the other tile's are read (the next tile's copy is
//   issued under this tile's dot, blend and sums);
// - the blend over the segment's active joints only (the joints with a
//   nonzero weight on any of its vertices, listed by the host with the part
//   index: PartIndex in ops/lbs_kernels.py), their [R|t] entries and weights
//   read through L1 (tmpl::blend_pos);
// - the 15 sums of each thread's 4 columns in registers over the segment,
//   then the block's 8 vertex groups in order into the segment's partial and
//   the segments in order per part (part_segments.cuh: tile_sums,
//   part_sum_kernel, shared with K6). No atomics: runs repeat bit for bit.
// A tile's rows past the segment read nothing and carry zero weights; the
// target's vertex edge and the batch edge are masked by global index.
#include "part_segments.cuh"

namespace {

using tmpl::NT;
using tmpl::SD_FLOATS;
using tmpl::TB;
using tmpl::TV;

// x [MAXE][TB] and two stages of shape directions; the sums' reduction after the walk.
constexpr int STAGE_FLOATS = tmpl::MAXE * TB + 2 * SD_FLOATS;
constexpr int BODY_FLOATS =
    STAGE_FLOATS > tile_sums::RED_FLOATS ? STAGE_FLOATS : tile_sums::RED_FLOATS;
constexpr size_t SMEM_BYTES = sizeof(float) * BODY_FLOATS + sizeof(int) * SEG_MAX;

// VEC: B % 4 == 0 and 16-byte aligned homog, pj, tgt: float4 loads; else
// 4-byte ones.
template <bool VEC, bool W>
__global__ void __launch_bounds__(NT, 1)
recon_cached_segments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                             const float* __restrict__ x, const float* __restrict__ sd,
                             const float* __restrict__ homog, const float* __restrict__ w,
                             const float* __restrict__ om, const int* __restrict__ verts,
                             const int* __restrict__ seg_offset, const int* __restrict__ joints,
                             const int* __restrict__ joint_offset, float* __restrict__ part,
                             int J, int E, int B, int Vt, int Vp, int om_rows, int om_rs,
                             int om_bs) {
  extern __shared__ float4 smem4[];
  float* const body = reinterpret_cast<float*>(smem4);  // x and the stages, then the sums
  float* const x_s = body;                              // [E][TB]
  float* const sd_s = body + tmpl::MAXE * TB;           // [2][3][E][SDL]
  int* const rows_s = reinterpret_cast<int*>(body + BODY_FLOATS);  // [SEG_MAX]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = 4 * (warp / 4) + lane / 8;  // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 8 * (warp % 4) + lane % 8;  // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;                // the thread's first column
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;
  const int j0 = joint_offset[seg_id], nA = joint_offset[seg_id + 1] - j0;
  const int n_tiles = (n + TV - 1) / TV;

  for (int i = threadIdx.x; i < SEG_MAX; i += NT) rows_s[i] = i < n ? verts[beg + i] : -1;
  tmpl::stage_columns(x_s, x, E, B, b0);
  __syncthreads();
  if (n_tiles > 0) tmpl::stage_shape_rows(sd_s, sd, rows_s, TV, E, Vp);
  sgemm::cp_async_commit();

  float acc[NS][4];
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    int vid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vid[i] = rows_s[tile * TV + 4 * tm + i];
    float h[3][4][4];
    tmpl::load3<VEC>(h, homog, Vp, vid, B, bc);
    // This tile's shape directions are in; the other stage was last read by
    // the previous tile, which every thread has finished.
    sgemm::cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles)
      tmpl::stage_shape_rows(sd_s + ((tile + 1) & 1) * SD_FLOATS, sd, rows_s + (tile + 1) * TV,
                             TV, E, Vp);
    sgemm::cp_async_commit();
    tmpl::add_shape_dot(h, sd_s + (tile & 1) * SD_FLOATS, x_s, E, tm, tn);
    float pos[3][4][4];
    tmpl::blend_pos<VEC>(pos, h, pj, w, joints + j0, nA, J, B, bc, vid);
    tile_sums::add<VEC, W>(acc, pos, tgt, om, vid, bc, B, Vt, om_rows, om_rs, om_bs);
  }
  sgemm::cp_async_wait<0>();
  tile_sums::store(acc, body, part, seg_id, b0, B, tm, tn);  // x and the stages are free
}

template <bool VEC, bool W>
cudaError_t launch_segments(const float* tgt, const float* pj, const float* x, const float* sd,
                            const float* homog, const float* w, const float* om,
                            const int* verts, const int* seg_offset, const int* joints,
                            const int* joint_offset, float* part, int J, int E, int B, int Vt,
                            int Vp, int n_seg, int om_rows, int om_rs, int om_bs,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(recon_cached_segments_kernel<VEC, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, n_seg);
  recon_cached_segments_kernel<VEC, W><<<grid, NT, SMEM_BYTES, stream>>>(
      tgt, pj, x, sd, homog, w, om, verts, seg_offset, joints, joint_offset, part, J, E, B, Vt,
      Vp, om_rows, om_rs, om_bs);
  return cudaGetLastError();
}

}  // namespace

// tgt (3, Vt, B), pj (12, J, B), x (E, B), sd (3, Vp, E), homog (3, Vp, B),
// w (Vp, J); om null, or the fit weights read as om[v * om_rs + b * om_bs]
// for v < min(Vt, om_rows); verts: the used vertices grouped by part;
// seg_offset (n_seg + 1): segment bounds in verts (at most 512 each);
// joints and joint_offset (n_seg + 1): each segment's active joints;
// part_seg (J + 1): each part's segment range -> raw (9, J, B), st (3, J, B),
// sa (3, J, B); part is scratch of n_seg * 15 * B floats. Requires E <= 32.
SMPL_API int recon_part_sums_launch(const float* tgt, const float* pj, const float* x,
                                    const float* sd, const float* homog, const float* w,
                                    const float* om, const int* verts, const int* seg_offset,
                                    const int* joints, const int* joint_offset,
                                    const int* part_seg, float* raw, float* st, float* sa,
                                    float* part, int J, int E, int B, int Vt, int Vp, int n_seg,
                                    int om_rows, int om_rs, int om_bs, cudaStream_t stream) {
  if (E > tmpl::MAXE || E < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (n_seg > 0) {
    const bool vec = B % 4 == 0 && sgemm::aligned16(homog) && sgemm::aligned16(pj) &&
                     sgemm::aligned16(tgt);
    cudaError_t err;
#define K4_CASE(v, wt)                                                                       \
  err = launch_segments<v, wt>(tgt, pj, x, sd, homog, w, om, verts, seg_offset, joints,      \
                               joint_offset, part, J, E, B, Vt, Vp, n_seg, om_rows, om_rs,   \
                               om_bs, stream);
    if (vec) {
      if (om == nullptr) { K4_CASE(true, false) } else { K4_CASE(true, true) }
    } else {
      if (om == nullptr) { K4_CASE(false, false) } else { K4_CASE(false, true) }
    }
#undef K4_CASE
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
