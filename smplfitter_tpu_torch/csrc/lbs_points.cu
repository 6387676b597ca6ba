// K1: extended linear blend skinning -> per-vertex points, (3, V_pad, B).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_lbs_points_kernel
// (launcher _lbs_points_impl). Same math: the 12 [R|t] entries of every joint
// are blended with the skinning weights and applied to the homogeneous
// template homog_c = consts_c . feat (c = 0..2; the 4th channel is 1).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, batch column) it
// does 3F FMAs of the template dot and 12 per joint that skins the vertex of
// the blend, against 12 bytes written: at SMPL-X b4096 (F = 503 for the
// fitted mesh, 3 joints per vertex) about 10496 * 4096 * 1545 * 2 = 133 GFLOP
// against 0.52 GB of stores, so the 67 TFLOP/s f32 rate is the roof (2.0 ms;
// the store alone 0.15 ms). Left now: f32 issue of the dot and the copies
// sharing the load/store pipe with it.
//
// Design: the vertices are walked through a cover (BlendSegments in
// ops/lbs_kernels.py: segments of at most 32 vertices of one body part, each
// with its active joints; every vertex below `covers` once). A block owns (a
// run of segments, 128 batch columns); each segment is one 32-row tile of
// template_tile.cuh: the template dot as a 4 x 4 x 3 register-tiled GEMM fed
// by a 4-stage cp.async ring across tile boundaries, then the blend over the
// segment's active joints only, [R|t] and weights read through L1. No
// per-joint staging: shared memory holds the ring and the run's vertex lists
// (61 KB), so two blocks share an SM (128 registers a thread). Each thread
// stores its 4 vertices x 3 channels as float4 along the batch. Rows from
// `covers` to V_pad (zero skinning weights: zero points) are cleared with one
// 2D memset.
#include "template_tile.cuh"

namespace {

using tmpl::NT;
using tmpl::TB;
using tmpl::TV;

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
lbs_points_kernel(const float* __restrict__ pj, const float* __restrict__ feat,
                  const float* __restrict__ w, const float* __restrict__ consts,
                  const int* __restrict__ verts, const int* __restrict__ seg_offset,
                  const int* __restrict__ joints, const int* __restrict__ joint_offset,
                  float* __restrict__ out, int J, int B, int F, int Vp, int n_seg,
                  int segs_per_block) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  int* const rows_s = reinterpret_cast<int*>(ring + tmpl::RING_FLOATS);  // [run][TV]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = 4 * (warp / 4) + lane / 8;  // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 8 * (warp % 4) + lane % 8;  // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int s0 = blockIdx.y * segs_per_block;
  const int n_tiles = min(segs_per_block, n_seg - s0);

  for (int i = threadIdx.x; i < n_tiles * TV; i += NT) {
    const int beg = seg_offset[s0 + i / TV], n = seg_offset[s0 + i / TV + 1] - beg;
    rows_s[i] = i % TV < n ? verts[beg + i % TV] : -1;
  }
  __syncthreads();

  const tmpl::Ring<VEC> rg(ring, rows_s, feat, consts, F, B, Vp, b0);
  tmpl::walk_tiles(rg, n_tiles, tm, tn, [&](int tile, const float (&h)[3][4][4]) {
    const int seg = s0 + tile;
    const int j0 = joint_offset[seg], nA = joint_offset[seg + 1] - j0;
    int vid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vid[i] = rows_s[tile * TV + 4 * tm + i];
    float pos[3][4][4];
    tmpl::blend_pos<VEC>(pos, h, pj, w, joints + j0, nA, J, B, bc, vid);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (vid[i] < 0) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        tmpl::store4<VEC>(out + ((size_t)a * Vp + vid[i]) * B + bc, pos[a][i], bc, B);
    }
  });
}

template <bool VEC>
cudaError_t launch(const float* pj, const float* feat, const float* w, const float* consts,
                   const int* verts, const int* seg_offset, const int* joints,
                   const int* joint_offset, float* out, int J, int B, int F, int Vp, int n_seg,
                   int segs_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tmpl::RING_FLOATS + sizeof(int) * segs_per_block * TV;
  cudaError_t err = cudaFuncSetAttribute(
      lbs_points_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, (n_seg + segs_per_block - 1) / segs_per_block);
  lbs_points_kernel<VEC><<<grid, NT, smem, stream>>>(pj, feat, w, consts, verts, seg_offset,
                                                     joints, joint_offset, out, J, B, F, Vp,
                                                     n_seg, segs_per_block);
  return cudaGetLastError();
}

}  // namespace

// pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F), the cover
// (verts, seg_offset (n_seg + 1), joints, joint_offset (n_seg + 1); every
// vertex below `covers` once, segments of at most 32) -> out (3, Vp, B),
// rows from `covers` on zero. segs_per_block: segments per block.
SMPL_API int lbs_points_launch(const float* pj, const float* feat, const float* w,
                               const float* consts, const int* verts, const int* seg_offset,
                               const int* joints, const int* joint_offset, float* out, int J,
                               int B, int F, int Vp, int n_seg, int segs_per_block, int covers,
                               cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (covers < Vp) {
    err = cudaMemset2DAsync(out + (size_t)covers * B, sizeof(float) * (size_t)Vp * B, 0,
                            sizeof(float) * (size_t)(Vp - covers) * B, 3, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_seg == 0 || B == 0) return (int)cudaSuccess;
  const bool vec = B % 4 == 0 && sgemm::aligned16(feat) && sgemm::aligned16(pj) &&
                   sgemm::aligned16(out);
  if (vec)
    err = launch<true>(pj, feat, w, consts, verts, seg_offset, joints, joint_offset, out, J, B,
                       F, Vp, n_seg, segs_per_block, stream);
  else
    err = launch<false>(pj, feat, w, consts, verts, seg_offset, joints, joint_offset, out, J, B,
                        F, Vp, n_seg, segs_per_block, stream);
  return (int)err;
}
