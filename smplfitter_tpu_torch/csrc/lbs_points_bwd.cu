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
// What bounds it on an H100: f32 arithmetic. Per (vertex, column) it recomputes
// the posed template (3F FMAs), projects g on the blended rotation (9J), and
// reduces 12 fields over the joints (12J) and 3 over the features (3F): at SMPL
// b4096 (F = 219, J = 24) about 7168 * 4096 * 1900 * 2 = 112 GFLOP against
// ~0.5 GB of traffic; the reductions read shared memory at 8 loads per 16 FMAs.
//
// Design: K1's tiles (lbs_tile.cuh) and the shared reductions of lbs_bwd.cuh.
// A block keeps its batch tile's [R|t] entries in shared memory, walks the
// 64-vertex tiles of its vertex split, and adds each tile's dpj and dfeat into
// its split's partials; split_sum_kernel adds the splits in order (no atomics).
// The F contraction stays in the kernel, as on the TPU: the per-vertex field
// (Rbar^T g) never goes to device memory. Vertex and batch edges are masked by
// global index, so any V_pad and B work.
#include "lbs_bwd.cuh"

using namespace lbs;
using namespace bwd;

namespace {

__global__ void __launch_bounds__(NT, 1)
lbs_points_bwd_kernel(const float* __restrict__ g, const float* __restrict__ pj,
                      const float* __restrict__ feat, const float* __restrict__ w,
                      const float* __restrict__ consts, float* __restrict__ part, int J, int B,
                      int F, int Vp, int tiles_per_block) {
  extern __shared__ float smem[];
  float* pj_s = smem;                 // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;    // [J][TVP]
  float* work = w_s + J * TVP;        // work_floats()
  float* coef_s = work + work_floats();  // [ROWS][TVP]
  const int b0 = blockIdx.x * TB;
  const int R = 12 * J + F;
  float* part_blk = part + (size_t)blockIdx.y * R * B;

  load_pj_tile(pj_s, pj, J, B, b0);
  zero_split(part_blk, R, B, b0);
  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, work and coef_s
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    float h[3][4][4];
    homog_tile(h, feat, consts, F, B, Vp, rows, b0, work);  // its barriers publish w_s
    float gv[3][4][4];
    load_field(gv, g, Vp, Vp, v0, B, b0);

#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) f[i][k] = gv[a][i][k] * (c < 3 ? h[c % 3][i][k] : 1.f);
        reduce_joint_field(part_blk, (a * 4 + c) * J, f, w_s, work, J, B, b0);
      }

    float u[3][4][4];
    project_rbar(u, gv, pj_s, w_s, J);
    reduce_feat(part_blk, 12 * J, u, consts, F, Vp, v0, B, b0, work, coef_s);
  }
}

}  // namespace

SMPL_API size_t lbs_points_bwd_smem_bytes(int J) {
  return sizeof(float) * (12 * J * TB + J * TVP + work_floats() + ROWS * TVP);
}

// g (3, Vp, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F) ->
// out (12 J + F, B): rows [0, 12J) dpj (12, J, B), then dfeat (F, B). part is
// scratch of n_splits * (12 J + F) * B floats, n_splits = ceil(ceil(Vp / 64) /
// tiles_per_block). Requires J <= 64.
SMPL_API int lbs_points_bwd_launch(const float* g, const float* pj, const float* feat,
                                   const float* w, const float* consts, float* out, float* part,
                                   int J, int B, int F, int Vp, int tiles_per_block,
                                   cudaStream_t stream) {
  if (J > ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = lbs_points_bwd_smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(
      lbs_points_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  dim3 grid((B + TB - 1) / TB, n_splits);
  lbs_points_bwd_kernel<<<grid, NT, smem, stream>>>(g, pj, feat, w, consts, part, J, B, F, Vp,
                                                    tiles_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_sum(part, out, n_splits, (size_t)(12 * J + F) * B, stream);
}
