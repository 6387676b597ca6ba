// K7: the posed zero-beta template of the large-F shape solve, (3, V_pad, B).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_posed_template_kernel
// (launcher _posed_template_impl, API posed_template_lm). Per vertex v and
// batch column b, homog_c[v, b] = sum_f consts[c, v, f] feat[f, b], c = 0..2
// (the homogeneous 4th channel is identically 1 and not formed). The models
// whose pose template is wide (SMPL-X F = 487, SMPL+H F = 460) compute it once
// per shape solve, and K2's cached form (rhs_moments.cu) and K4
// (recon_part_sums.cu) read it, instead of every kernel rerunning the F-deep
// dot on its own; per-call fit weights run it on every model (SMPL F = 208,
// MANO F = 136).
//
// With the channel folded into the rows it is one row-major GEMM,
// C (3 V_pad x B) = A (3 V_pad x F) feat (F x B): consts is channel-major
// (>= 3, V_pad, F), so its first three channels are A, and C is the output
// as it stands.
//
// What bounds it on an H100: f32 arithmetic on the CUDA cores (no TF32, no
// tensor cores: the fit's precision rule). At SMPL-X b4096 it is
// 3 * 10496 * 487 * 4096 * 2 = 126 GFLOP, 1.9 ms at the 67 TFLOP/s f32 peak,
// against ~0.6 GB of traffic (0.52 GB of it the output), 0.18 ms at 3.35 TB/s.
//
// Design: the register-tiled GEMM of sgemm_tile.cuh with a 128-row x
// 256-column block tile (8 x 16 per thread; 5.3 FMAs per float read from
// shared memory), one block of 256 threads per SM (up to 255 registers, no
// spills), 16 features per k tile, a 4-stage cp.async ring: tiles t + 1 ..
// t + 3 are in flight while tile t's FMAs run, with one barrier per tile.
// A's rows are F-contiguous with an odd stride (F = 487), and the FMA loop
// wants them k-major, so each element goes by its own 4-byte cp.async
// straight to its transposed place in shared memory: a warp copies 8
// consecutive features of 4 rows per instruction, and the stage's row stride
// (128 + 4) puts its 32 writes in 32 banks; no register staging, no store
// instructions. feat is batch-contiguous: 16-byte cp.async where B % 4 == 0
// (4-byte copies otherwise). Each thread's copy addresses are fixed offsets
// from two pointers set up once, so a copy costs few integer instructions
// beside the FMAs. The batch tiles of one row tile are neighbours in the grid, so the
// row tile's A (128 x 487 x 4 bytes) comes from L2. The feature, row and
// batch edges are masked.
#include "sgemm_tile.cuh"

using namespace sgemm;

namespace {

constexpr int MI = 2, NI = 4;   // row and column groups of the micro-tile
constexpr int TM = 64 * MI;     // rows of C per block
constexpr int TN = 64 * NI;     // batch columns per block
constexpr int KT = 16;          // features per k tile
constexpr int NS = 4;           // stages of the copy ring
constexpr int LDA = TM + 4;     // row stride of the k-major A stage
constexpr int A_FLOATS = KT * LDA;
constexpr int B_FLOATS = KT * TN;
constexpr size_t SMEM_BYTES = sizeof(float) * NS * (A_FLOATS + B_FLOATS);

// A's copies: a warp covers AK features of 32 / AK rows, the block RP rows
// per pass; feat's: a pass covers KP features.
constexpr int AK = 8;
constexpr int RP = (32 / AK) * (NT / 32) / (KT / AK);
constexpr int KP = NT / (TN / 4);
static_assert(TM % RP == 0 && KT % KP == 0 && (NT / 32) % (KT / AK) == 0, "copy passes");

// VEC: 16-byte copies of feat (B % 4 == 0, feat 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
posed_template_kernel(const float* __restrict__ feat, const float* __restrict__ A,
                      float* __restrict__ C, int F, int B, int M) {
  extern __shared__ float4 smem4[];
  float* const a_s = reinterpret_cast<float*>(smem4);  // [NS][KT][LDA]
  float* const b_s = a_s + NS * A_FLOATS;              // [NS][KT][TN]
  const int b0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const Lane lt = lane_tile();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The thread's A copies: feature ka of rows ma + RP q.
  const int ka = AK * (warp % (KT / AK)) + lane % AK;
  const int ma = (32 / AK) * (warp / (KT / AK)) + lane / AK;
  const float* const a_src = A + (size_t)(m0 + ma) * F + ka;
  const int rows_live = M - m0 - ma;  // rows ma + RP q < M - m0 are live
  // The thread's 16-byte feat copies: columns bb .. bb + 3 of features kb + KP q.
  const int kb = threadIdx.x / (TN / 4), bb = 4 * (threadIdx.x % (TN / 4));
  const float* const b_src = feat + (size_t)kb * B + b0 + bb;
  const bool live_b = b0 + bb < B;

  auto issue = [&](int f0, int slot) {
    float* as = a_s + slot * A_FLOATS + ka * LDA + ma;
    const bool live_k = f0 + ka < F;
#pragma unroll
    for (int q = 0; q < TM / RP; ++q) {
      const bool live = live_k && RP * q < rows_live;
      cp_async4(as + RP * q, live ? a_src + (size_t)RP * q * F + f0 : A, live);
    }
    float* bs = b_s + slot * B_FLOATS;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < KT / KP; ++q) {
        const bool live = live_b && f0 + kb + KP * q < F;
        cp_async16(bs + (kb + KP * q) * TN + bb,
                   live ? b_src + (size_t)(f0 + KP * q) * B : feat, live);
      }
    } else {
      for (int e = threadIdx.x; e < B_FLOATS; e += NT) {
        const int k = e / TN, b = e % TN;
        const bool live = f0 + k < F && b0 + b < B;
        cp_async4(bs + e, live ? feat + (size_t)(f0 + k) * B + b0 + b : feat, live);
      }
    }
  };

  float acc[4 * MI][4 * NI];
  zero<MI, NI>(acc);
  const int nk = (F + KT - 1) / KT;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) issue(s * KT, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    // Tile t has landed; tile t - 1 is consumed, so its slot takes t + NS - 1.
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (t + NS - 1 < nk) issue((t + NS - 1) * KT, (t + NS - 1) % NS);
    cp_async_commit();
    fma_steps<MI, NI, KT>(acc, a_s + (t % NS) * A_FLOATS, LDA, b_s + (t % NS) * B_FLOATS, TN,
                          lt);
  }
  store_tile<MI, NI>(C, B, M, B, m0, b0, acc, lt, B % 4 == 0 && aligned16(C));
}

}  // namespace

// feat (F, B), consts (>= 3, Vp, F) -> out (3, Vp, B).
SMPL_API int posed_template_launch(const float* feat, const float* consts, float* out, int F,
                                   int B, int Vp, cudaStream_t stream) {
  const int M = 3 * Vp;
  auto kernel = B % 4 == 0 && aligned16(feat) ? posed_template_kernel<true>
                                              : posed_template_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TN - 1) / TN, (M + TM - 1) / TM);
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(feat, consts, out, F, B, M);
  return (int)cudaGetLastError();
}
