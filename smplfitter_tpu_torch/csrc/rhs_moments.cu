// K2: fused residual projection of the shape solve, emit-homog form.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_rhs_kernel
// (launcher _rhs_moments_impl, API rhs_moments_h). Per vertex and batch
// column: the posed template homog_c = consts_c . feat (written out for this
// iteration's recon kernel), the LBS position pos = blended [R|t] . homog, the
// residual b = tgt - pos, and its two vertex reductions
//     y[a, j, :] = sum_v w[v, j] b_a(v)                        (3, J, B)
//     r[e, :]    = sum_v sum_c SD[c, v, e] (Rbar_v^T b_v)_c     (E, B)
// where Rbar_v is the rotation part of the blended transform.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, batch column): 3F
// FMAs of homog dot, 12J of position, 12J of the Rbar^T b projection and 3J + 3E
// of reductions; at SMPL b4096 (F = 208, J = 24, E = 10) about 7168 * 4096 *
// 1300 * 2 = 76 GFLOP against ~0.7 GB of traffic (targets in, homog out).
//
// Design: the TPU grid swept the vertex chunks of a batch tile in order and
// accumulated into the output block. Here blocks run in parallel with no
// order, so a block owns (batch tile, vertex split): it walks its split's
// 64-vertex tiles, accumulating y and r per batch column in shared memory,
// and writes one partial per split. A second kernel sums the partials over
// splits in a fixed order, so runs repeat bit for bit (no float atomics). The
// homog dot and the position reuse the shared tile routines of K1; the
// residual never leaves registers except as a shared-memory tile for the
// reductions. The target's vertex edge (V_t <= V_pad rows) and the batch edge
// are masked by global index.
#include "lbs_tile.cuh"

using namespace lbs;

namespace {

__global__ void __launch_bounds__(NT, 1)
rhs_moments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                   const float* __restrict__ feat, const float* __restrict__ w,
                   const float* __restrict__ consts, const float* __restrict__ sd,
                   float* __restrict__ homog, float* __restrict__ part, int J, int B,
                   int F, int E, int Vt, int Vp, int tiles_per_block) {
  extern __shared__ float smem[];
  const int R = 3 * J + E;
  float* pj_s = smem;                   // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;      // [J][TVP]
  float* sd_s = w_s + J * TVP;          // [3][E][TVP]
  float* acc_s = sd_s + 3 * E * TVP;    // [R][TB]
  float* work = acc_s + R * TB;         // staging, or a [3][TV][TB] reduction tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col = threadIdx.x % TB, grp = threadIdx.x / TB;  // reduction roles
  const int b0 = blockIdx.x * TB;

  load_pj_tile(pj_s, pj, J, B, b0);
  for (int idx = threadIdx.x; idx < R * TB; idx += NT) acc_s[idx] = 0.f;

  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TV;
    if (v0 >= Vp) break;  // uniform across the block
    __syncthreads();      // the previous tile is done with w_s, sd_s and work
    load_w_tile(w_s, w, J, Vp, v0);
    for (int idx = threadIdx.x; idx < TV * 3 * E; idx += NT) {
      const int ce = idx % (3 * E), vv = idx / (3 * E);
      const int v = v0 + vv;
      sd_s[ce * TVP + vv] = (v < Vp) ? sd[((size_t)(ce / E) * Vp + v) * E + ce % E] : 0.f;
    }

    float h[3][4][4];
    homog_tile(h, feat, consts, F, B, Vp, v0, b0, work);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b0 + tx + 16 * k;
        if (v < Vp && b < B) {
#pragma unroll
          for (int c = 0; c < 3; ++c) homog[((size_t)c * Vp + v) * B + b] = h[c][i][k];
        }
      }
    }

    // Residual b = tgt - pos (zero outside the target's rows and the batch).
    float res[3][4][4];
    pos_tile(res, h, pj_s, w_s, J);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = v0 + ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b0 + tx + 16 * k;
        const bool ok = v < Vt && b < B;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          res[a][i][k] = ok ? tgt[((size_t)a * Vt + v) * B + b] - res[a][i][k] : 0.f;
      }
    }

    // g_c = (Rbar^T b)_c = sum_j w[v, j] sum_a pj[a*4+c, j, b] b_a.
    float g[3][4][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[c][i][k] = 0.f;
    for (int j = 0; j < J; ++j) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = w_s[j * TVP + ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float p[9];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) p[a * 3 + c] = pj_s[((a * 4 + c) * J + j) * TB + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float s =
                fmaf(p[c], res[0][i][k], fmaf(p[3 + c], res[1][i][k], p[6 + c] * res[2][i][k]));
            g[c][i][k] = fmaf(wv[i], s, g[c][i][k]);
          }
      }
    }

    // y rows: acc[a*J + j] += sum_vv w[v, j] b_a(v).
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) work[(a * TV + ty + 16 * i) * TB + tx + 16 * k] = res[a][i][k];
    __syncthreads();
    for (int r = grp; r < 3 * J; r += NT / TB) {
      const int a = r / J, j = r % J;
      float s = 0.f;
#pragma unroll 8
      for (int vv = 0; vv < TV; ++vv)
        s = fmaf(w_s[j * TVP + vv], work[(a * TV + vv) * TB + col], s);
      acc_s[r * TB + col] += s;
    }
    __syncthreads();

    // r rows: acc[3J + e] += sum_vv sum_c SD[c, v, e] g_c(v).
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) work[(c * TV + ty + 16 * i) * TB + tx + 16 * k] = g[c][i][k];
    __syncthreads();
    for (int e = grp; e < E; e += NT / TB) {
      float s = 0.f;
      for (int c = 0; c < 3; ++c) {
#pragma unroll 8
        for (int vv = 0; vv < TV; ++vv)
          s = fmaf(sd_s[(c * E + e) * TVP + vv], work[(c * TV + vv) * TB + col], s);
      }
      acc_s[(3 * J + e) * TB + col] += s;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * TB; idx += NT) {
    const int r = idx / TB, bb = idx % TB;
    const int b = b0 + bb;
    if (b < B) part[((size_t)blockIdx.y * R + r) * B + b] = acc_s[idx];
  }
}

// Sums the per-split partials in split order: rows [0, 3J) -> y, [3J, 3J+E) -> r.
__global__ void rhs_split_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                                     float* __restrict__ r_out, int n_splits, int J, int E,
                                     int B) {
  const int R = 3 * J + E;
  const size_t n = (size_t)R * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part[(size_t)sp * n + idx];
    const size_t r = idx / B;
    if (r < (size_t)(3 * J)) y[idx] = s;
    else r_out[idx - (size_t)3 * J * B] = s;
  }
}

}  // namespace

SMPL_API size_t rhs_moments_smem_bytes(int J, int E) {
  const int work = staging_floats() > 3 * TV * TB ? staging_floats() : 3 * TV * TB;
  return sizeof(float) * (12 * J * TB + J * TVP + 3 * E * TVP + (3 * J + E) * TB + work);
}

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F),
// sd (3, Vp, E) -> r (E, B), y (3, J, B), homog (3, Vp, B); part is scratch of
// n_splits * (3J + E) * B floats with n_splits = ceil(ceil(Vp / 64) / tiles_per_block).
SMPL_API int rhs_moments_launch(const float* tgt, const float* pj, const float* feat,
                                const float* w, const float* consts, const float* sd,
                                float* r_out, float* y, float* homog, float* part, int J,
                                int B, int F, int E, int Vt, int Vp, int tiles_per_block,
                                cudaStream_t stream) {
  const size_t smem = rhs_moments_smem_bytes(J, E);
  cudaError_t err = cudaFuncSetAttribute(
      rhs_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (Vp + TV - 1) / TV;
  const int n_splits = (n_vtiles + tiles_per_block - 1) / tiles_per_block;
  dim3 grid((B + TB - 1) / TB, n_splits);
  rhs_moments_kernel<<<grid, NT, smem, stream>>>(tgt, pj, feat, w, consts, sd, homog, part,
                                                 J, B, F, E, Vt, Vp, tiles_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)(3 * J + E) * B;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  rhs_split_sum_kernel<<<blocks, threads, 0, stream>>>(part, y, r_out, n_splits, J, E, B);
  return (int)cudaGetLastError();
}
