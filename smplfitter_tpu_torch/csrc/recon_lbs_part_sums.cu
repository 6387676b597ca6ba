// K6: reconstruction by extended LBS, fused into per-part sums.
//
// Replaces the TPU kernel
// smplfitter_tpu/ops/lbs_kernels.py:_recon_part_sums_kernel (launcher
// _recon_part_sums_impl, API recon_part_sums_lm), unweighted. It is K4
// without the posed-template cache: per vertex v and batch column the
// homogeneous template homog_c = consts_c . feat (an F-deep dot, F = 207 + 1
// + E at SMPL), pos = blended [R|t] . homog, and with p(v) the vertex's body
// part, raw[c*3+d, p] += t_c pos_d, s_t[c, p] += t_c, s_a[d, p] += pos_d. The
// reconstructed mesh never reaches device memory, as on the TPU. The
// fit-weighted form (W) multiplies pos by ω in every sum and t by ω in s_t,
// ω the static column (V_pad, 1) or per-call weights (V, B)
// (part_segments.cuh:fit_weight).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): 3F FMAs of
// the template dot, 12 per joint that skins the vertex of the blend and 15
// of the sums; at SMPL-X b4096 (F = 503, 3 joints per vertex) about 10475 *
// 4096 * 1560 * 2 = 134 GFLOP against ~0.25 GB read.
//
// Design: a block owns (segment of one part's vertex list, 128 batch
// columns) and walks the segment in tiles of 32 listed vertices.
// - The template dot and the blend are those of template_tile.cuh: a 4 x 4
//   x 3 register tile per thread fed by a 4-stage cp.async ring that runs on
//   across tile boundaries (48 FMAs per 4 shared loads), then a blend over
//   the segment's active joints only (the joints with a nonzero weight on
//   any of its vertices, listed by the host with the part index: PartIndex
//   in ops/lbs_kernels.py), their [R|t] entries and weights read through L1.
// - The 15 sums of each thread's 4 columns stay in registers over the
//   segment; the block sums its 8 vertex groups in order into the segment's
//   partial, which part_sum_kernel sums per part in segment order (both
//   shared with K4: part_segments.cuh, tile_sums and part_sum_kernel). No atomics: runs repeat bit for bit. A tile's rows past
//   the segment gather nothing (zero fill) and carry zero weights.
#include "part_segments.cuh"
#include "template_tile.cuh"

namespace {

using tmpl::NT;
using tmpl::TB;
using tmpl::TV;

constexpr int BODY_FLOATS = tmpl::RING_FLOATS > tile_sums::RED_FLOATS ? tmpl::RING_FLOATS
                                                                      : tile_sums::RED_FLOATS;
constexpr size_t SMEM_BYTES = sizeof(float) * BODY_FLOATS + sizeof(int) * SEG_MAX;

// VEC: B % 4 == 0 and 16-byte aligned feat, pj, tgt (and per-call ω):
// float4 copies and loads; else 4-byte ones.
template <bool VEC, bool W>
__global__ void __launch_bounds__(NT, 1)
recon_lbs_segments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                          const float* __restrict__ feat, const float* __restrict__ w,
                          const float* __restrict__ consts, const float* __restrict__ om,
                          const int* __restrict__ verts, const int* __restrict__ seg_offset,
                          const int* __restrict__ joints, const int* __restrict__ joint_offset,
                          float* __restrict__ part, int J, int B, int F, int Vt, int Vp,
                          int om_rows, int om_rs, int om_bs) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);  // the template ring, then the sums
  int* const rows_s = reinterpret_cast<int*>(ring + BODY_FLOATS);  // [SEG_MAX]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = 4 * (warp / 4) + lane / 8;   // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 8 * (warp % 4) + lane % 8;   // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;                 // the thread's first column
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;
  const int j0 = joint_offset[seg_id], nA = joint_offset[seg_id + 1] - j0;
  const int n_tiles = (n + TV - 1) / TV;

  for (int i = threadIdx.x; i < SEG_MAX; i += NT) rows_s[i] = i < n ? verts[beg + i] : -1;
  __syncthreads();

  float acc[NS][4];
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

  const tmpl::Ring<VEC> rg(ring, rows_s, feat, consts, F, B, Vp, b0);
  tmpl::walk_tiles(rg, n_tiles, tm, tn, [&](int tile, const float (&h)[3][4][4]) {
    // The tile's template is complete: blend over the active joints, then sums.
    int vid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vid[i] = rows_s[tile * TV + 4 * tm + i];
    float pos[3][4][4];
    tmpl::blend_pos<VEC>(pos, h, pj, w, joints + j0, nA, J, B, bc, vid);
    tile_sums::add<VEC, W>(acc, pos, tgt, om, vid, bc, B, Vt, om_rows, om_rs, om_bs);
  });
  tile_sums::store(acc, ring, part, seg_id, b0, B, tm, tn);  // the ring is free
}

template <bool VEC, bool W>
cudaError_t launch_segments(const float* tgt, const float* pj, const float* feat, const float* w,
                            const float* consts, const float* om, const int* verts,
                            const int* seg_offset, const int* joints, const int* joint_offset,
                            float* part, int J, int B, int F, int Vt, int Vp, int n_seg,
                            int om_rows, int om_rs, int om_bs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(recon_lbs_segments_kernel<VEC, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, n_seg);
  recon_lbs_segments_kernel<VEC, W><<<grid, NT, SMEM_BYTES, stream>>>(
      tgt, pj, feat, w, consts, om, verts, seg_offset, joints, joint_offset, part, J, B, F, Vt,
      Vp, om_rows, om_rs, om_bs);
  return cudaGetLastError();
}

}  // namespace

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F);
// om null or fit weights, verts, seg_offset (n_seg + 1; segments of at most
// 512 vertices), joints and joint_offset (n_seg + 1: each segment's active
// joints), part_seg (J + 1) as in recon_part_sums_launch -> raw (9, J, B),
// st (3, J, B), sa (3, J, B); part is scratch of n_seg * 15 * B floats.
SMPL_API int recon_lbs_part_sums_launch(const float* tgt, const float* pj, const float* feat,
                                        const float* w, const float* consts, const float* om,
                                        const int* verts, const int* seg_offset,
                                        const int* joints, const int* joint_offset,
                                        const int* part_seg, float* raw, float* st, float* sa,
                                        float* part, int J, int B, int F, int Vt, int Vp,
                                        int n_seg, int om_rows, int om_rs, int om_bs,
                                        cudaStream_t stream) {
  if (n_seg > 0) {
    const bool vec = B % 4 == 0 && sgemm::aligned16(feat) && sgemm::aligned16(pj) &&
                     sgemm::aligned16(tgt);
    cudaError_t err;
#define K6_CASE(v, wt)                                                                    \
  err = launch_segments<v, wt>(tgt, pj, feat, w, consts, om, verts, seg_offset, joints,   \
                               joint_offset, part, J, B, F, Vt, Vp, n_seg, om_rows, om_rs, \
                               om_bs, stream);
    if (vec) {
      if (om == nullptr) { K6_CASE(true, false) } else { K6_CASE(true, true) }
    } else {
      if (om == nullptr) { K6_CASE(false, false) } else { K6_CASE(false, true) }
    }
#undef K6_CASE
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
