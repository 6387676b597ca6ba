// K1: extended linear blend skinning -> per-vertex points, (3, V_pad, B).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_lbs_points_kernel
// (launcher _lbs_points_impl). Same math: the 12 [R|t] entries of every joint
// are blended with the skinning weights and applied to the homogeneous
// template homog_c = consts_c . feat (c = 0..2; the 4th channel is 1).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, batch column) it
// does 3F FMAs of homog dot plus 12J of blend, against 12 bytes written:
// at SMPL b4096 (F = 219, J = 24) about 7168 * 4096 * 945 * 2 = 55 GFLOP
// against ~0.4 GB of traffic, so the 67 TFLOP/s f32 rate is the roof.
//
// Design: each block loads its batch tile's per-joint [R|t] entries (12 x J x
// 64 floats) into shared memory once, then walks several 64-vertex tiles. Per
// tile the homog dot runs as a shared-memory-tiled GEMM with a 4 x 4 register
// micro-tile per thread, and the blend is folded into the application (the
// joint sum outermost), so no blended transform is ever stored. The vertex edge
// is masked by global row index and the batch edge by column index, so any
// V_pad and any B work.
#include "lbs_tile.cuh"

using namespace lbs;

namespace {

__global__ void __launch_bounds__(NT)
lbs_points_kernel(const float* __restrict__ pj, const float* __restrict__ feat,
                  const float* __restrict__ w, const float* __restrict__ consts,
                  float* __restrict__ out, int J, int B, int F, int Vp,
                  int tiles_per_block) {
  extern __shared__ float smem[];
  float* pj_s = smem;                  // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;     // [J][TVP]
  float* stage = w_s + J * TVP;        // staging_floats()
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB;

  load_pj_tile(pj_s, pj, J, B, b0);
  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done reading w_s
    const TileRows rows{v0, Vp};
    load_w_tile(w_s, w, J, rows);
    float h[3][4][4];
    homog_tile(h, feat, consts, F, B, Vp, rows, b0, stage);
    float pos[3][4][4];
    pos_tile(pos, h, pj_s, w_s, J);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
      if (v >= Vp) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b0 + tx + 16 * k;
        if (b >= B) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) out[((size_t)a * Vp + v) * B + b] = pos[a][i][k];
      }
    }
  }
}

}  // namespace

SMPL_API size_t lbs_points_smem_bytes(int J) {
  return sizeof(float) * (12 * J * TB + J * TVP + staging_floats());
}

// pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F) -> out (3, Vp, B).
SMPL_API int lbs_points_launch(const float* pj, const float* feat, const float* w,
                               const float* consts, float* out, int J, int B, int F,
                               int Vp, int tiles_per_block, cudaStream_t stream) {
  const size_t smem = lbs_points_smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(
      lbs_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  dim3 grid((B + TB - 1) / TB, (n_vtiles + tiles_per_block - 1) / tiles_per_block);
  lbs_points_kernel<<<grid, NT, smem, stream>>>(pj, feat, w, consts, out, J, B, F, Vp,
                                                tiles_per_block);
  return (int)cudaGetLastError();
}
