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
// What bounds it on an H100: f32 arithmetic. It is a GEMM with M = E^2 (256
// at SMPL-X), N = B and K = J3^2 (27225): at b4096 27225 * 256 * 4096 * 2 =
// 57 GFLOP, 0.85 ms at the 67 TFLOP/s f32 peak; the bytes (Ksd 27.9 MB, R
// 8 MB, G1 4 MB) take 0.012 ms. The X that an unfused product would
// materialize is 446 MB at that size.
//
// Design: the register-tiled GEMM of sgemm_tile.cuh with a 256-row x
// 128-column block tile (16 x 8 per thread; all of G1's 256 rows at E = 16,
// so X is built once per batch tile), one block of 256 threads per SM, split
// over K so that the grid fills the card in one wave (term1_splits in
// ops/lbs_kernels.py: 4 splits of the 32 tiles at SMPL-X b4096). X is never
// stored: each 40-deep k stage is 5 values of j by 8 of k, and a thread
// builds its X entries from R, 3 FMAs each: the 8 k rows of R of its k block
// sit in shared memory (reloaded, with one extra barrier, when the k block
// changes), the 5 j rows come with the stage. The stages walk k blocks
// outermost and j within a block, so a stage's Ksd rows (j J3 + k) are 5
// runs of 8 consecutive rows. Ksd (27.9 MB) and R (8 MB) stay in the 50 MB
// L2. The Ksd slice and the j rows of R go through a 3-stage cp.async ring
// (16-byte copies where E^2 % 4 == 0 and B % 4 == 0, 4-byte ones otherwise,
// as at the kid factor's E^2 = 289): stage s + 2 is in flight while stage
// s + 1's X is built and stage s's FMAs run, with one barrier per stage. Each
// split writes its partial to a scratch (S, E^2, B) and split_sum_kernel
// (split_sum.cuh) adds the splits in order: no atomics, two runs give the same
// bits. E^2 <= 1024; any J3 and B; the j, k, row and batch edges are masked.
#include "sgemm_tile.cuh"
#include "split_sum.cuh"

namespace {

using sgemm::Lane;
using sgemm::NT;

constexpr int MI = 4, NI = 2;  // row and column groups of the micro-tile
constexpr int TM = 64 * MI;    // rows of G1 per block
constexpr int TN = 64 * NI;    // batch columns per block
constexpr int KB = 8;          // k values per k block: one per warp
constexpr int JS = 5;          // j values per stage
constexpr int BK = KB * JS;    // rows of Ksd and X per stage
constexpr int NS = 3;          // stages of the copy ring
static_assert(NT == 32 * KB && TN == 128, "a warp builds 4 x 32 X entries of one k");

constexpr int A_FLOATS = BK * TM;       // one Ksd slice
constexpr int RJ_FLOATS = JS * 3 * TN;  // one stage's j rows of R
constexpr int X_FLOATS = BK * TN;       // one stage of X
constexpr int RK_FLOATS = 3 * KB * TN;  // a k block's rows of R
constexpr size_t SMEM_BYTES =
    sizeof(float) * (NS * (A_FLOATS + RJ_FLOATS) + 2 * X_FLOATS + RK_FLOATS);

__host__ __device__ inline int stages_of(int J3) {
  return ((J3 + KB - 1) / KB) * ((J3 + JS - 1) / JS);
}

// VEC_A: 16-byte copies of Ksd rows (EE % 4 == 0); VEC_R: 16-byte copies and
// loads of R rows (B % 4 == 0).
template <bool VEC_A, bool VEC_R>
__global__ void __launch_bounds__(NT, 1)
term1_kernel(const float* __restrict__ R, const float* __restrict__ ksd,
             float* __restrict__ part, int J3, int EE, int B, int n_splits) {
  extern __shared__ float4 smem4[];
  float* const a_s = reinterpret_cast<float*>(smem4);  // [NS][BK][TM]
  float* const rj_s = a_s + NS * A_FLOATS;             // [NS][JS][3][TN]
  float* const x_s = rj_s + NS * RJ_FLOATS;            // [2][BK][TN]
  float* const rk_s = x_s + 2 * X_FLOATS;              // [3][KB][TN]
  const int b0 = blockIdx.x * TN, m0 = blockIdx.y * TM, sp = blockIdx.z;
  const int njs = (J3 + JS - 1) / JS;
  const long n_total = stages_of(J3);
  const int t0 = (int)(n_total * sp / n_splits);
  const int n = (int)(n_total * (sp + 1) / n_splits) - t0;
  const Lane lt = sgemm::lane_tile();
  // The thread's k in a k block, and its 4 columns of a 128-column row.
  const int kk = threadIdx.x / 32, c4 = threadIdx.x % 32;

  // The thread's 16-byte copies of R's j rows: row rr = jj 3 + a of a stage
  // (rr = warp + 8 p, p < ceil(3 JS / 8)), columns 4 c4 .. 4 c4 + 3.
  constexpr int RR = 3 * JS, RPASS = (RR + KB - 1) / KB;
  int r_jj[RPASS], r_off[RPASS];
#pragma unroll
  for (int p = 0; p < RPASS; ++p) {
    const int rr = kk + KB * p;
    r_jj[p] = rr < RR ? rr / 3 : J3;  // J3: no such row (never live)
    r_off[p] = (rr % 3) * J3 * B;
  }
  const bool live_rb = b0 + 4 * c4 < B;

  // Stage t: k block t / njs, j values (t % njs) JS + jj; X row jj KB + kk.
  auto issue = [&](int t, int slot) {
    const int k = (t / njs) * KB + kk, j0 = (t % njs) * JS;
    float* as = a_s + slot * A_FLOATS;
    if (VEC_A) {  // the thread's chunks: rows (j0 + jj, k), columns 4 (c4 + 32 h)
      const float* src = ksd + ((size_t)j0 * J3 + k) * EE + m0 + 4 * c4;
#pragma unroll
      for (int jj = 0; jj < JS; ++jj)
#pragma unroll
        for (int h = 0; h < TM / 128; ++h) {
          const bool live = j0 + jj < J3 && k < J3 && m0 + 4 * (c4 + 32 * h) < EE;
          sgemm::cp_async16(as + (jj * KB + kk) * TM + 4 * (c4 + 32 * h),
                            live ? src + (size_t)jj * J3 * EE + 128 * h : ksd, live);
        }
    } else {
      for (int e = threadIdx.x; e < A_FLOATS; e += NT) {
        const int r = e / TM, m = e % TM;
        const int j = j0 + r / KB, kr = (t / njs) * KB + r % KB;
        const bool live = j < J3 && kr < J3 && m0 + m < EE;
        sgemm::cp_async4(as + e, live ? ksd + ((size_t)j * J3 + kr) * EE + m0 + m : ksd, live);
      }
    }
    float* rs = rj_s + slot * RJ_FLOATS;  // row jj * 3 + a: R[a, j0 + jj, b0:b0 + TN]
    if (VEC_R) {
      const float* src = R + (size_t)j0 * B + b0 + 4 * c4;
#pragma unroll
      for (int p = 0; p < RPASS; ++p) {
        if (kk + KB * p >= RR) continue;
        const bool live = live_rb && j0 + r_jj[p] < J3;
        sgemm::cp_async16(rs + (kk + KB * p) * TN + 4 * c4,
                          live ? src + r_off[p] + (size_t)r_jj[p] * B : R, live);
      }
    } else {
      for (int e = threadIdx.x; e < RJ_FLOATS; e += NT) {
        const int row = e / TN, b = e % TN;
        const int j = j0 + row / 3, a = row % 3;
        const bool live = j < J3 && b0 + b < B;
        sgemm::cp_async4(rs + e, live ? R + ((size_t)a * J3 + j) * B + b0 + b : R, live);
      }
    }
  };

  // The k rows of R of k block kb, R[a, kb KB + kk, b0:b0 + TN], into rk_s
  // (zero past the k and batch edges). The caller syncs before and after.
  auto load_rk = [&](int kb) {
    for (int e = threadIdx.x; e < RK_FLOATS / 4; e += NT) {
      const int row = e / (TN / 4), b = b0 + 4 * (e % (TN / 4));
      const int a = row / KB, k = kb * KB + row % KB;
      const float* src = R + ((size_t)a * J3 + k) * B + b;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < J3) {
        if (VEC_R) {
          if (b < B) v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v = make_float4(b < B ? __ldg(src) : 0.f, b + 1 < B ? __ldg(src + 1) : 0.f,
                          b + 2 < B ? __ldg(src + 2) : 0.f, b + 3 < B ? __ldg(src + 3) : 0.f);
        }
      }
      reinterpret_cast<float4*>(rk_s)[e] = v;
    }
  };

  // The X rows jj KB + kk of a stage from its j rows of R (ring slot) and
  // the k block's rows in rk_s.
  auto build_x = [&](int slot, int buf) {
    float4 rk[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rk[a] = *reinterpret_cast<const float4*>(rk_s + (a * KB + kk) * TN + 4 * c4);
    const float* rs = rj_s + slot * RJ_FLOATS;
    float* xs = x_s + buf * X_FLOATS;
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float4 rj = *reinterpret_cast<const float4*>(rs + (jj * 3 + a) * TN + 4 * c4);
        x.x = fmaf(rj.x, rk[a].x, x.x);
        x.y = fmaf(rj.y, rk[a].y, x.y);
        x.z = fmaf(rj.z, rk[a].z, x.z);
        x.w = fmaf(rj.w, rk[a].w, x.w);
      }
      *reinterpret_cast<float4*>(xs + (jj * KB + kk) * TN + 4 * c4) = x;
    }
  };

  float acc[4 * MI][4 * NI];
  sgemm::zero<MI, NI>(acc);
  if (n > 0) {  // block-uniform
    issue(t0, 0);
    sgemm::cp_async_commit();
    if (n > 1) issue(t0 + 1, 1);
    sgemm::cp_async_commit();
    int kb_held = t0 / njs;
    load_rk(kb_held);
    sgemm::cp_async_wait<1>();
    __syncthreads();
    build_x(0, 0);
    for (int i = 0; i < n; ++i) {
      // Stage i + 1 has landed; stage i's X is visible; stage i - 1 is consumed.
      sgemm::cp_async_wait<0>();
      __syncthreads();
      if (i + 2 < n) issue(t0 + i + 2, (i + 2) % NS);
      sgemm::cp_async_commit();
      if (i + 1 < n) {
        const int kb = (t0 + i + 1) / njs;
        if (kb != kb_held) {  // block-uniform; every X of the old block is built
          kb_held = kb;
          load_rk(kb);
          __syncthreads();
        }
        build_x((i + 1) % NS, (i + 1) % 2);
      }
      sgemm::fma_steps<MI, NI, BK>(acc, a_s + (i % NS) * A_FLOATS, TM,
                                   x_s + (i % 2) * X_FLOATS, TN, lt);
    }
  }
  float* const dst = part + (size_t)sp * EE * B;
  sgemm::store_tile<MI, NI>(dst, B, EE, B, m0, b0, acc, lt,
                            B % 4 == 0 && sgemm::aligned16(dst));
}

}  // namespace

// R (3, J3, B), ksd (J3^2, EE) -> G (EE, B), through the partials part
// (n_splits, EE, B) (unused, and may be null, for one split). EE <= 1024;
// 1 <= n_splits <= the number of k stages, ceil(J3 / 8) ceil(J3 / 5).
SMPL_API int term1_launch(const float* R, const float* ksd, float* part, float* G, int J3,
                          int EE, int B, int n_splits, cudaStream_t stream) {
  if (EE > 32 * 32 || n_splits < 1 || n_splits > stages_of(J3) || (n_splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  float* const dst = n_splits == 1 ? G : part;
  const bool vec_a = EE % 4 == 0 && sgemm::aligned16(ksd);
  const bool vec_r = B % 4 == 0 && sgemm::aligned16(R);
  auto kernel = vec_a ? (vec_r ? term1_kernel<true, true> : term1_kernel<true, false>)
                      : (vec_r ? term1_kernel<false, true> : term1_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TN - 1) / TN, (EE + TM - 1) / TM, n_splits);
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(R, ksd, dst, J3, EE, B, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return (int)launch_split_sum(part, G, n_splits, (size_t)EE * B, stream);
}
