// The feature cotangent of the backward LBS kernels K10 (lbs_points_bwd.cu)
// and K14 (recon_lbs_part_sums_bwd.cu) as one split-K GEMM:
//     dfeat[f, b] = sum_c sum_v consts[c, v, f] U[c, v, b],   (F, B)
// where U (3, V_pad, B) is Rbar^T of the vertex cotangent that the kernel's
// front wrote (zero on the rows it does not walk). This is the contraction
// the TPU kernels keep in their body (_lbs_grads_chunk in
// smplfitter_tpu/ops/lbs_kernels.py); here it is M = F, K = 3 V_pad, N = B,
// with A = consts[:3] viewed as (3 V_pad, F) and B = U as (3 V_pad, B).
//
// What bounds it on an H100: f32 arithmetic. At SMPL-X b4096 (F = 503,
// V_pad = 10496) 2 * 503 * 31488 * 4096 = 130 GFLOP, 1.9 ms at the 67
// TFLOP/s f32 peak, against the 0.52 GB of U read once (0.15 ms).
//
// Design: the register-tiled GEMM of sgemm_tile.cuh (K7's tile: 128 feature
// rows x 256 batch columns, 8 x 16 accumulators per thread, one 256-thread
// block per SM, 16-deep k tiles through a 4-stage cp.async ring). Both
// operands are k-major in memory, so both stages copy straight: a k row of A
// is a consts row of F contiguous floats (4-byte copies: F is odd, so rows
// are not 16-byte aligned; a warp copies 32 consecutive features of one
// row), a k row of B is U's row of B contiguous floats (16-byte copies where
// B % 4 == 0). The grid has few (feature, batch) tiles (64 at SMPL-X b4096),
// so the K sum is split to fill one wave (dfeat_splits in
// ops/lbs_kernels.py), each split into its own partial, and split_sum_kernel
// adds the splits in order: no atomics, two runs give the same bits. All
// arithmetic is f32 FMAs on the CUDA cores (no TF32, no tensor cores). The
// feature, batch and k edges are masked (zero fill). K runs over every
// row: a gather of the walked rows only (k over a vertex list, the A rows
// looked up per copy) measured slower on the card than this contiguous walk.
#include "sgemm_tile.cuh"
#include "split_sum.cuh"

using namespace sgemm;

namespace {

constexpr int MI = 2, NI = 4;  // row and column groups of the micro-tile
constexpr int TM = 64 * MI;    // features per block
constexpr int TN = 64 * NI;    // batch columns per block
constexpr int KT = 16;         // k rows per stage
constexpr int NS = 4;          // stages of the copy ring
constexpr int A_FLOATS = KT * TM;
constexpr int B_FLOATS = KT * TN;
constexpr size_t SMEM_BYTES = sizeof(float) * NS * (A_FLOATS + B_FLOATS);

// A's copies: thread t copies feature t % TM of k rows t / TM + AR q.
constexpr int AR = NT / TM;        // k rows per pass
constexpr int AQ = KT / AR;        // passes
// B's 16-byte copies: columns 4 (t % (TN / 4)) of k rows t / (TN / 4) + KP q.
constexpr int KP = NT / (TN / 4);
static_assert(KT % AR == 0 && KT % KP == 0, "copy passes");

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
dfeat_gemm_kernel(const float* __restrict__ consts, const float* __restrict__ U,
                  float* __restrict__ C, int F, int B, int K, int nk, int n_splits) {
  extern __shared__ float4 smem4[];
  float* const a_s = reinterpret_cast<float*>(smem4);  // [NS][KT][TM]
  float* const b_s = a_s + NS * A_FLOATS;              // [NS][KT][TN]
  const int b0 = blockIdx.x * TN, m0 = blockIdx.y * TM, sp = blockIdx.z;
  const int kt0 = (int)((long)nk * sp / n_splits);
  const int n = (int)((long)nk * (sp + 1) / n_splits) - kt0;
  const Lane lt = lane_tile();
  // The thread's A copies: feature ma of k rows ka + AR q.
  const int ma = threadIdx.x % TM, ka = threadIdx.x / TM;
  const bool live_m = m0 + ma < F;
  const float* const a_col = consts + m0 + ma;
  // The thread's 16-byte U copies: columns bb .. bb + 3 of k rows kb + KP q.
  const int kb = threadIdx.x / (TN / 4), bb = 4 * (threadIdx.x % (TN / 4));
  const bool live_b = b0 + bb < B;

  auto issue = [&](int kt, int slot) {
    const int k0 = kt * KT;
    float* as = a_s + slot * A_FLOATS + ka * TM + ma;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int k = k0 + ka + AR * q;
      const bool live = live_m && k < K;
      cp_async4(as + AR * q * TM, live ? a_col + (size_t)k * F : consts, live);
    }
    float* bs = b_s + slot * B_FLOATS;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < KT / KP; ++q) {
        const int k = k0 + kb + KP * q;
        const bool live = live_b && k < K;
        cp_async16(bs + (kb + KP * q) * TN + bb, live ? U + (size_t)k * B + b0 + bb : U, live);
      }
    } else {
      for (int e = threadIdx.x; e < B_FLOATS; e += NT) {
        const int k = k0 + e / TN, b = b0 + e % TN;
        const bool live = k < K && b < B;
        cp_async4(bs + e, live ? U + (size_t)k * B + b : U, live);
      }
    }
  };

  float acc[4 * MI][4 * NI];
  zero<MI, NI>(acc);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) issue(kt0 + s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    // Stage t has landed; stage t - 1 is consumed, so its slot takes t + NS - 1.
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (t + NS - 1 < n) issue(kt0 + t + NS - 1, (t + NS - 1) % NS);
    cp_async_commit();
    fma_steps<MI, NI, KT>(acc, a_s + (t % NS) * A_FLOATS, TM, b_s + (t % NS) * B_FLOATS, TN,
                          lt);
  }
  cp_async_wait<0>();
  float* const dst = C + (size_t)sp * F * B;
  store_tile<MI, NI>(dst, B, F, B, m0, b0, acc, lt, B % 4 == 0 && aligned16(dst));
}

}  // namespace

// consts (>= 3, Vp, F), U (3, Vp, B) -> out (F, B), through the partials part
// (n_splits, F, B) (unused, and may be null, for one split).
// 1 <= n_splits <= ceil(3 Vp / 16).
SMPL_API int dfeat_gemm_launch(const float* consts, const float* U, float* part, float* out,
                               int F, int B, int Vp, int n_splits, cudaStream_t stream) {
  const int K = 3 * Vp;
  const int nk = (K + KT - 1) / KT;
  if (n_splits < 1 || n_splits > nk || (n_splits > 1 && !part)) return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return (int)cudaSuccess;
  float* const dst = n_splits == 1 ? out : part;
  auto kernel = B % 4 == 0 && aligned16(U) ? dfeat_gemm_kernel<true> : dfeat_gemm_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TN - 1) / TN, (F + TM - 1) / TM, n_splits);
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(consts, U, dst, F, B, K, nk, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return (int)launch_split_sum(part, out, n_splits, (size_t)F * B, stream);
}
