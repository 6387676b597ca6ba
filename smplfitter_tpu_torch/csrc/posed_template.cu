// K7: the posed zero-beta template of the large-F shape solve, (3, V_pad, B).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_posed_template_kernel
// (launcher _posed_template_impl, API posed_template_lm). Per vertex v and
// batch column b, homog_c[v, b] = sum_f consts[c, v, f] feat[f, b], c = 0..2
// (the homogeneous 4th channel is identically 1 and not formed). The models
// whose pose template is wide (SMPL-X F = 487, SMPL+H F = 460) compute it once
// per shape solve, and K2's cached form (rhs_moments.cu) and K4
// (recon_part_sums.cu) read it, instead of every kernel rerunning the F-deep
// dot on its own.
//
// What bounds it on an H100: f32 arithmetic on the CUDA cores (no TF32, no
// tensor cores: the fit's precision rule). At SMPL-X b4096 it is
// 3 * 10496 * 487 * 4096 * 2 = 126 GFLOP, 1.9 ms at the 67 TFLOP/s f32 peak,
// against ~0.6 GB of traffic (0.52 GB of it the output), 0.18 ms at 3.35 TB/s.
//
// Design: the GEMM is K1's homog dot without the blend. A block owns a tile of
// 64 vertices x 64 batch columns and runs the shared-memory-tiled dot of
// lbs_tile.cuh (16 feature rows staged per step, a 4 x 4 register micro-tile
// of each of the three channels per thread), then writes its (3, 64, 64)
// output once: no reduction across blocks. The batch tiles of one vertex tile
// are neighbours in the grid, so the 0.37 MB of constants they share is read
// from L2. The vertex and batch edges are masked, so any V_pad and B work.
#include "lbs_tile.cuh"

using namespace lbs;

namespace {

__global__ void __launch_bounds__(NT)
posed_template_kernel(const float* __restrict__ feat, const float* __restrict__ consts,
                      float* __restrict__ out, int F, int B, int Vp) {
  __shared__ float stage[staging_floats()];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB, v0 = blockIdx.y * TV;
  float h[3][4][4];
  homog_tile(h, feat, consts, F, B, Vp, TileRows{v0, Vp}, b0, stage);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= Vp) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = b0 + tx + 16 * k;
      if (b >= B) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[((size_t)c * Vp + v) * B + b] = h[c][i][k];
    }
  }
}

}  // namespace

// feat (F, B), consts (>= 3, Vp, F) -> out (3, Vp, B).
SMPL_API int posed_template_launch(const float* feat, const float* consts, float* out, int F,
                                   int B, int Vp, cudaStream_t stream) {
  dim3 grid((B + TB - 1) / TB, (Vp + TV - 1) / TV);
  posed_template_kernel<<<grid, NT, 0, stream>>>(feat, consts, out, F, B, Vp);
  return (int)cudaGetLastError();
}
