// K8: the streamed term1 of the large-J Gramian, G1 = Ksd^T . X  (E^2, B).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_term1_kernel
// (launcher _term1_blocked). For every batch column b,
//     G1[(e,f), b] = sum_{x=(j,k)} Ksd[x, (e,f)] X[x, b],
//     X[(j,k), b]  = sum_a R[a, j, b] R[a, k, b],
// with R (3, J3, B) the rotations (rows (joint, c)) and Ksd (J3^2, E^2) the
// static shape-direction moments. The rest of the Gramian is small per-column
// contractions (gram_mparts_ref in ops/lbs_kernels.py, as the JAX package
// leaves them to XLA). Models with J3^2 E^2 4 bytes of Ksd above 2.75 MB take
// this route (SMPL-X J3 = 165: 27.9 MB; SMPL+H J3 = 156: 24.9 MB); SMPL keeps
// the fused K3 (gram_assembly.cu).
//
// What bounds it on an H100: f32 arithmetic. At SMPL-X b4096, E = 16:
// 27225 * 256 * 4096 * 2 = 57 GFLOP, 0.85 ms at the 67 TFLOP/s f32 peak; the
// bytes (Ksd 27.9 MB, R 8 MB, G1 4 MB) take 0.012 ms. The X that an
// unfused product would materialize is 446 MB at that size.
//
// Design: X is never stored. A block owns (64 batch columns, 128 rows of G1)
// and keeps its columns' rotations in shared memory (3 x J3 x 64 floats,
// 127 KB at J3 = 165). It walks the J3^2 rows of Ksd in slices of 32: it
// stages the slice's 32 x 128 block of Ksd and builds the matching 32 x 64
// block of X from the rotations, then each thread accumulates an 8 x 4
// register micro-tile (8 rows of G1 by 4 columns, both read as float4). Ksd
// (27.9 MB) stays in the 50 MB L2 and is streamed once per block, B / 64
// times per row block, not B / 16 times as in K3. Sums run in a fixed order:
// each slice's 32 terms into a partial, the partials into the total, so runs
// repeat bit for bit and the 27225-term sum keeps its error near the f32
// rounding of about 850 partials. No atomics. E <= 32 (up to 8 row blocks of
// 128); the batch and row edges are masked.
#include <cuda_runtime.h>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int NT = 256;
constexpr int TB8 = 64;   // batch columns per block
constexpr int RG = 128;   // rows of G1 per block
constexpr int KX = 32;    // rows of Ksd and X per staged slice
constexpr int MR = 8;     // rows of G1 per thread
constexpr int MC = 4;     // columns per thread
static_assert((RG / MR) * (TB8 / MC) == NT, "one micro-tile per thread");

__global__ void __launch_bounds__(NT)
term1_kernel(const float* __restrict__ Rm, const float* __restrict__ ksd,
             float* __restrict__ G, int J3, int EE, int B) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* R_s = smem;                   // [3][J3][TB8]
  float* ksd_s = R_s + 3 * J3 * TB8;   // [KX][RG]
  float* X_s = ksd_s + KX * RG;        // [KX][TB8]
  const int tx = threadIdx.x % (TB8 / MC), ty = threadIdx.x / (TB8 / MC);
  const int b0 = blockIdx.x * TB8, r0 = blockIdx.y * RG;

  for (int idx = threadIdx.x; idx < 3 * J3 * TB8; idx += NT) {
    const int c = idx % TB8, ax = idx / TB8;
    R_s[idx] = (b0 + c < B) ? Rm[(size_t)ax * B + b0 + c] : 0.f;
  }

  float acc[MR][MC];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int n = 0; n < MC; ++n) acc[m][n] = 0.f;

  const int n_x = J3 * J3;
  for (int x0 = 0; x0 < n_x; x0 += KX) {
    __syncthreads();  // R_s is loaded; the previous slice is consumed
    for (int idx = threadIdx.x; idx < KX * RG; idx += NT) {
      const int x = x0 + idx / RG, r = r0 + idx % RG;
      ksd_s[idx] = (x < n_x && r < EE) ? ksd[(size_t)x * EE + r] : 0.f;
    }
    for (int idx = threadIdx.x; idx < KX * TB8; idx += NT) {
      const int x = x0 + idx / TB8, c = idx % TB8;
      float xv = 0.f;
      if (x < n_x) {
        const int j = x / J3, k = x % J3;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          xv = fmaf(R_s[(a * J3 + j) * TB8 + c], R_s[(a * J3 + k) * TB8 + c], xv);
      }
      X_s[idx] = xv;
    }
    __syncthreads();

    float part[MR][MC];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < MC; ++n) part[m][n] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KX; ++kk) {
      const float4 k0 = *reinterpret_cast<const float4*>(&ksd_s[kk * RG + ty * MR]);
      const float4 k1 = *reinterpret_cast<const float4*>(&ksd_s[kk * RG + ty * MR + 4]);
      const float4 xq = *reinterpret_cast<const float4*>(&X_s[kk * TB8 + tx * MC]);
      const float kv[MR] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float xv[MC] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < MC; ++n) part[m][n] = fmaf(kv[m], xv[n], part[m][n]);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < MC; ++n) acc[m][n] += part[m][n];
  }

#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = r0 + ty * MR + m;
    if (r >= EE) continue;
#pragma unroll
    for (int n = 0; n < MC; ++n) {
      const int b = b0 + tx * MC + n;
      if (b < B) G[(size_t)r * B + b] = acc[m][n];
    }
  }
}

}  // namespace

SMPL_API size_t term1_smem_bytes(int J3) {
  return sizeof(float) * (3 * J3 * TB8 + KX * RG + KX * TB8);
}

// R (3, J3, B), ksd (J3^2, EE) -> G (EE, B). Requires EE <= 1024 (E <= 32).
SMPL_API int term1_launch(const float* Rm, const float* ksd, float* G, int J3, int EE, int B,
                          cudaStream_t stream) {
  if (EE > 32 * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = term1_smem_bytes(J3);
  cudaError_t err = cudaFuncSetAttribute(term1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + TB8 - 1) / TB8, (EE + RG - 1) / RG);
  term1_kernel<<<grid, NT, smem, stream>>>(Rm, ksd, G, J3, EE, B);
  return (int)cudaGetLastError();
}
