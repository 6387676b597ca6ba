// K3: per-instance Gramian assembly of the shape solve.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_gram_kernel
// (launcher _gram_assembly_impl, API gram_assembly). For every batch column,
// from the joint-space operands R (3, 3J, B), T (3, EJ, B), y (3, J, B) and
// the joints block P (3, EJ, B), bJ (3, J, B):
//     G  = Ksd : X + M1 + M1^T + M2 [+ M3]        with X = sum_a R_a R_a^T
//     SA = sd1 . R + sum_j W1_j T [+ sum_j P]      (3E, B)
//     rb = sum_aj T y [+ sum_aj P bJ]              (E, B)
//     Sb = sum_j y [+ sum_j bJ]                    (3, B)
// (M1 = Z^T T with Z = Lz^T R, M2 = (qT)^T T, M3 = P^T P), i.e. the math of
// gram_assembly_ref.
//
// What bounds it on an H100: f32 arithmetic. term1 = Ksd : X is a GEMM with
// M = E^2, N = B and K = J3^2 (at SMPL b4096 5184 * 100 * 4096 * 2 = 4.2
// GFLOP); the per-column terms add about 0.19 MFLOP a column (0.77 GFLOP at
// b4096), most of it Z = Lz^T R_a (3 E J J3 FMAs a column).
//
// Design: two kernels, both hand-written; no atomics, so two runs give the
// same bits.
// 1. term1 by K8's split-K register-tiled GEMM (term1.cu: X built per k stage
//    from R, never stored) with 128-row tiles, 8 x 8 accumulators a thread:
//    E^2 = 100 or 121 fills 78% or 95% of a tile, where K8's 256 rows would
//    fill 39%. The k stages are split so that the grid fills one wave of the
//    card, with at least 4 of them a split (gram_splits in
//    ops/lbs_kernels.py: 4 splits of 32 tiles at b4096, 33 splits at b32);
//    each split writes its partial to a scratch (S, E^2, B).
// 2. gram_terms_kernel: a block of 256 threads owns 16 batch columns and
//    stages their R and T (and P) in shared memory once, coalesced. Then:
//    - SA, rb and Sb, one (output row, column) per thread at a time, while P
//      is staged;
//    - M3 = P P^T, then Z = Lz^T R_a and M1 = Z T^T, then Q = q T_a and
//      M2 = Q T^T. Z and Q are register-tiled products over the block's
//      columns: a thread owns 4 rows (e, j .. j + 3) x 4 columns for all three
//      a, so one float4 of Lz (read through L1) or of q^T (staged) feeds 48
//      FMAs with three float4 of R or T from shared memory. P, Z and Q take
//      turns in one shared buffer. In the M sums a thread owns the pairs
//      (e, f) with e = g / 4 + 4 i, f = g % 4 + 4 i' (g: its group of the
//      column's 16 threads) in registers; each load is a row of 16 columns;
//    - G = the S partials in split order + M1 + M1^T (the transpose through
//      shared memory) + M2 [+ M3].
//    E <= 16; any J whose staging fits in shared memory (J = 24: 108 KB at
//    E = 10, 160 KB at E = 16).
#include "sgemm_tile.cuh"

namespace {

constexpr int NT = 256;
constexpr int TC = 16;                      // batch columns per block
constexpr int NG = NT / TC;                 // threads per column
constexpr int MAXE = 16;                    // E <= 16
constexpr int MQ = MAXE / 4;                // e (and f) values per thread of the M sums
constexpr int CG = TC / 4;                  // column groups of 4 in the row products
constexpr int RG_PER_PASS = NT / CG;        // row groups of the row products per pass
static_assert(NG == 4 * MQ, "a column's threads split e and f four ways each");

__host__ __device__ inline int padded4(int n) { return (n + 3) / 4 * 4; }

// Shared memory: R [3][J3][TC], T [3][EJ][TC], a work buffer W [3][EJ][TC]
// (P, Z, Q, then M1) and q^T [J][padded4(J)].
__host__ __device__ inline size_t terms_smem_floats(int J, int E) {
  return (size_t)9 * J * TC + (size_t)6 * E * J * TC + (size_t)J * padded4(J);
}

// acc[i][i'] += sum_a sum_k Ls[a, e_i J + k] Rs[a, f_i' J + k] at column c,
// e_i = min(eb + 4 i, E - 1), f_i' = min(fb + 4 i', E - 1): every load is
// unconditional, so a step's loads issue together; the pairs past E repeat
// a valid row and are never written.
__device__ __forceinline__ void add_products(float (&acc)[MQ][MQ], const float* Ls,
                                             const float* Rs, int J, int E, int eb, int fb,
                                             int c) {
  const int EJ = E * J;
  int lr[MQ], rr[MQ];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    lr[i] = min(eb + 4 * i, E - 1) * J * TC + c;
    rr[i] = min(fb + 4 * i, E - 1) * J * TC + c;
  }
  for (int a = 0; a < 3; ++a) {
    const float* la = Ls + a * EJ * TC;
    const float* ra = Rs + a * EJ * TC;
#pragma unroll 2
    for (int k = 0; k < J; ++k) {
      float l[MQ], r[MQ];
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        l[i] = la[lr[i] + k * TC];
        r[i] = ra[rr[i] + k * TC];
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int q = 0; q < MQ; ++q) acc[i][q] = fmaf(l[i], r[q], acc[i][q]);
    }
  }
}

// W[a, e J + j, :] = sum_{x < n_x} coef(x, e, j0)[j - j0] S[a s_a + e s_e + x, :]
// for the rows (e, j) of the thread's row groups (4 consecutive j of one e,
// j0 = 4 jg; rows past J are not written) and all three a, 4 columns a
// thread. coef returns the 4 coefficients of rows j0 .. j0 + 3 (zero past J).
template <typename Coef>
__device__ __forceinline__ void row_products(float* W, const float* S, int s_a, int s_e, int n_x,
                                             int J, int E, Coef coef) {
  const int EJ = E * J, JG = (J + 3) / 4;
  const int col = 4 * (threadIdx.x % CG);
  for (int rg = threadIdx.x / CG; rg < E * JG; rg += RG_PER_PASS) {
    const int e = rg / JG, j0 = 4 * (rg % JG);
    const float* src = S + (size_t)e * s_e * TC + col;
    float acc[3][4][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][i][k] = 0.f;
#pragma unroll 2
    for (int x = 0; x < n_x; ++x) {
      const float4 l4 = coef(x, e, j0);
      const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float4 s = *reinterpret_cast<const float4*>(src + (size_t)(a * s_a + x) * TC);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[a][i][0] = fmaf(l[i], s.x, acc[a][i][0]);
          acc[a][i][1] = fmaf(l[i], s.y, acc[a][i][1]);
          acc[a][i][2] = fmaf(l[i], s.z, acc[a][i][2]);
          acc[a][i][3] = fmaf(l[i], s.w, acc[a][i][3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j0 + i < J)
          *reinterpret_cast<float4*>(W + (size_t)(a * EJ + e * J + j0 + i) * TC + col) =
              make_float4(acc[a][i][0], acc[a][i][1], acc[a][i][2], acc[a][i][3]);
  }
}

// Rows [0, n) of a (n, B) array at the block's columns b0 .. b0 + TC - 1 into
// dst [n][TC], zero past B, by 4-byte cp.async copies (the caller commits,
// waits and syncs): every copy of the block in flight at once.
__device__ __forceinline__ void stage_columns(float* dst, const float* __restrict__ src, int n,
                                              int B, int b0) {
  for (int idx = threadIdx.x; idx < n * TC; idx += NT) {
    const int row = idx / TC, c = idx % TC;
    const bool live = b0 + c < B;
    sgemm::cp_async4(dst + idx, live ? src + (size_t)row * B + b0 + c : src, live);
  }
}

// HJ: the joints block P, bJ; VEC_LZ: Lz's rows read as float4 (J % 4 == 0).
template <bool HJ, bool VEC_LZ>
__global__ void __launch_bounds__(NT, 2)
gram_terms_kernel(const float* __restrict__ Rm, const float* __restrict__ T,
                  const float* __restrict__ y, const float* __restrict__ P,
                  const float* __restrict__ bJ, const float* __restrict__ lz,
                  const float* __restrict__ sd1, const float* __restrict__ q,
                  const float* __restrict__ w1, const float* __restrict__ part,
                  float* __restrict__ G, float* __restrict__ SA, float* __restrict__ rb,
                  float* __restrict__ Sb, int J, int E, int B, int n_splits) {
  extern __shared__ float4 smem4[];
  const int J3 = 3 * J, EJ = E * J, EE = E * E, JP = padded4(J);
  float* const R_s = reinterpret_cast<float*>(smem4);  // [3][J3][TC]
  float* const T_s = R_s + 3 * J3 * TC;                // [3][EJ][TC]
  float* const W_s = T_s + 3 * EJ * TC;                // [3][EJ][TC]
  float* const q_s = W_s + 3 * EJ * TC;                // [J][JP]: q^T
  const int b0 = blockIdx.x * TC;
  const int c = threadIdx.x % TC, g = threadIdx.x / TC;
  const int b = b0 + c;
  const bool live = b < B;

  stage_columns(R_s, Rm, 3 * J3, B, b0);
  stage_columns(T_s, T, 3 * EJ, B, b0);
  if (HJ) stage_columns(W_s, P, 3 * EJ, B, b0);
  sgemm::cp_async_commit();
  for (int idx = threadIdx.x; idx < J * JP; idx += NT) {
    const int k = idx / JP, j = idx % JP;
    q_s[idx] = j < J ? __ldg(q + j * J + k) : 0.f;
  }
  sgemm::cp_async_wait<0>();
  __syncthreads();

  // SA (3E rows), rb (E) and Sb (3) of column c: row it of the 4E + 3.
  for (int it = g; it < 4 * E + 3; it += NG) {
    float s = 0.f;
    float* out;
    if (it < 3 * E) {
      const int a = it / E, e = it % E;
#pragma unroll 8
      for (int x = 0; x < J3; ++x) s = fmaf(__ldg(sd1 + x * E + e), R_s[(a * J3 + x) * TC + c], s);
      const float* t = T_s + (a * EJ + e * J) * TC + c;
#pragma unroll 8
      for (int j = 0; j < J; ++j) s = fmaf(__ldg(w1 + j), t[j * TC], s);
      if (HJ) {
        const float* p = W_s + (a * EJ + e * J) * TC + c;
#pragma unroll 8
        for (int j = 0; j < J; ++j) s += p[j * TC];
      }
      out = SA + (size_t)it * B;
    } else if (it < 4 * E) {
      const int e = it - 3 * E;
      if (live) {
        for (int a = 0; a < 3; ++a)
#pragma unroll 8
          for (int j = 0; j < J; ++j) {
            s = fmaf(T_s[(a * EJ + e * J + j) * TC + c], __ldg(y + (size_t)(a * J + j) * B + b), s);
            if (HJ)
              s = fmaf(W_s[(a * EJ + e * J + j) * TC + c],
                       __ldg(bJ + (size_t)(a * J + j) * B + b), s);
          }
      }
      out = rb + (size_t)e * B;
    } else {
      const int a = it - 4 * E;
      if (live) {
#pragma unroll 8
        for (int j = 0; j < J; ++j) {
          s += __ldg(y + (size_t)(a * J + j) * B + b);
          if (HJ) s += __ldg(bJ + (size_t)(a * J + j) * B + b);
        }
      }
      out = Sb + (size_t)a * B;
    }
    if (live) out[b] = s;
  }

  const int eb = g / MQ, fb = g % MQ;
  float m1[MQ][MQ], mo[MQ][MQ];  // M1; M2 (+ M3)
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int k = 0; k < MQ; ++k) m1[i][k] = mo[i][k] = 0.f;
  if (HJ) add_products(mo, W_s, W_s, J, E, eb, fb, c);  // M3
  __syncthreads();

  // Z[a, (e, j)] = sum_x Lz[x, e J + j] R[a, x], then M1 = Z T^T.
  row_products(W_s, R_s, J3, 0, J3, J, E, [&](int x, int e, int j0) {
    const float* l = lz + (size_t)x * EJ + e * J + j0;
    if (VEC_LZ) return __ldg(reinterpret_cast<const float4*>(l));
    return make_float4(__ldg(l), j0 + 1 < J ? __ldg(l + 1) : 0.f, j0 + 2 < J ? __ldg(l + 2) : 0.f,
                       j0 + 3 < J ? __ldg(l + 3) : 0.f);
  });
  __syncthreads();
  add_products(m1, W_s, T_s, J, E, eb, fb, c);
  __syncthreads();

  // Q[a, (e, j)] = sum_k q[j, k] T[a, (e, k)], then M2 = Q T^T.
  row_products(W_s, T_s, EJ, J, J, J, E, [&](int k, int, int j0) {
    return *reinterpret_cast<const float4*>(q_s + k * JP + j0);
  });
  __syncthreads();
  add_products(mo, W_s, T_s, J, E, eb, fb, c);
  __syncthreads();

  // G = sum over splits (in order) of term1's partials + (M1 + M1^T + mo).
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int k = 0; k < MQ; ++k) {
      const int e = eb + 4 * i, f = fb + 4 * k;
      if (e < E && f < E) W_s[(e * E + f) * TC + c] = m1[i][k];
    }
  __syncthreads();
  if (!live) return;
  int row[MQ][MQ];  // the pairs' rows of G (clamped past E: read, never written)
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int k = 0; k < MQ; ++k) {
      const int e = min(eb + 4 * i, E - 1), f = min(fb + 4 * k, E - 1);
      row[i][k] = e * E + f;
      mo[i][k] += m1[i][k] + W_s[(f * E + e) * TC + c];
    }
  float t1[MQ][MQ];  // term1: the splits added in order
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int k = 0; k < MQ; ++k) t1[i][k] = 0.f;
#pragma unroll 2
  for (int sp = 0; sp < n_splits; ++sp) {
    const float* ps = part + (size_t)sp * EE * B + b;
    float v[MQ][MQ];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int k = 0; k < MQ; ++k) v[i][k] = __ldg(ps + (size_t)row[i][k] * B);
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int k = 0; k < MQ; ++k) t1[i][k] += v[i][k];
  }
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int k = 0; k < MQ; ++k)
      if (eb + 4 * i < E && fb + 4 * k < E) G[(size_t)row[i][k] * B + b] = t1[i][k] + mo[i][k];
}

template <bool HJ>
cudaError_t launch_terms(const float* Rm, const float* T, const float* y, const float* P,
                         const float* bJ, const float* lz, const float* sd1, const float* q,
                         const float* w1, const float* part, float* G, float* SA, float* rb,
                         float* Sb, int J, int E, int B, int n_splits, cudaStream_t stream) {
  const bool vec_lz = J % 4 == 0 && sgemm::aligned16(lz);
  auto kernel = vec_lz ? gram_terms_kernel<HJ, true> : gram_terms_kernel<HJ, false>;
  const size_t smem = sizeof(float) * terms_smem_floats(J, E);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + TC - 1) / TC, NT, smem, stream>>>(Rm, T, y, P, bJ, lz, sd1, q, w1, part, G, SA,
                                                  rb, Sb, J, E, B, n_splits);
  return cudaGetLastError();
}

}  // namespace

// K3's second kernel (the first is term1_tiles_launch in term1.cu with
// 128-row tiles): R (3, 3J, B), T (3, EJ, B), y (3, J, B), P (3, EJ, B), bJ
// (3, J, B) [P, bJ unread unless has_joints], lz (3J, EJ), sd1 (3J, E), q
// (J, J), w1 (J,), part (n_splits, E^2, B) from the first -> G (E^2, B), SA
// (3E, B), rb (E, B), Sb (3, B). Requires E <= 16.
SMPL_API int gram_terms_launch(const float* Rm, const float* T, const float* y, const float* P,
                               const float* bJ, const float* lz, const float* sd1, const float* q,
                               const float* w1, const float* part, float* G, float* SA, float* rb,
                               float* Sb, int J, int E, int B, int has_joints, int n_splits,
                               cudaStream_t stream) {
  if (E > MAXE || n_splits < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      has_joints ? launch_terms<true>(Rm, T, y, P, bJ, lz, sd1, q, w1, part, G, SA, rb, Sb, J, E, B,
                                      n_splits, stream)
                 : launch_terms<false>(Rm, T, y, P, bJ, lz, sd1, q, w1, part, G, SA, rb, Sb, J, E,
                                       B, n_splits, stream);
  return (int)err;
}
