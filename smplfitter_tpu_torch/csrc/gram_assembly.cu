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
// What bounds it on an H100: the term1 contraction Ksd : X. Ksd (9J^2 x E^2,
// 2.07 MB at SMPL) is read by every block and X (9J^2 per column) is formed on
// the fly: at b4096 that is 5184 * 100 * 4096 * 2 = 4.2 GFLOP of f32 FMA fed
// from shared memory; everything else is ~0.1 MFLOP per column.
//
// Design: a block owns 16 batch columns and all their outputs (no cross-block
// reduction). Ksd streams through shared memory in 32-row slices, each slice's
// X rows are built from the block's rotations (kept in shared memory), and
// each thread accumulates up to 16 rows of G for one column in registers. The
// small per-column terms then run with one thread per (E-row, column), their
// T and P operands staged in shared memory one coordinate at a time, and M1's
// transpose is read back from shared memory when G is written. The batch edge
// is masked, so any B works.
#include <cuda_runtime.h>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int NT = 256;
constexpr int TB3 = 16;            // batch columns per block
constexpr int NG = NT / TB3;       // thread groups (16)
constexpr int KX = 32;             // Ksd rows per staged slice
constexpr int MAXE = 16;           // E <= 16
constexpr int ROWS = MAXE * MAXE / NG;  // G rows per thread (upper bound)

__global__ void __launch_bounds__(NT)
gram_assembly_kernel(const float* __restrict__ Rm, const float* __restrict__ T,
                     const float* __restrict__ y, const float* __restrict__ P,
                     const float* __restrict__ bJ, const float* __restrict__ ksd,
                     const float* __restrict__ lz, const float* __restrict__ sd1,
                     const float* __restrict__ q, const float* __restrict__ w1,
                     float* __restrict__ G, float* __restrict__ SA, float* __restrict__ rb,
                     float* __restrict__ Sb, int J, int E, int B, int has_joints) {
  extern __shared__ float smem[];
  const int J3 = 3 * J, EJ = E * J, EE = E * E;
  float* R_s = smem;                   // [3][J3][TB3]
  float* ksd_s = R_s + 3 * J3 * TB3;   // [KX][EE]
  float* X_s = ksd_s + KX * EE;        // [KX][TB3]
  float* T_s = X_s + KX * TB3;         // [EJ][TB3], one coordinate a at a time
  float* P_s = T_s + EJ * TB3;         // [EJ][TB3]
  float* M1_s = P_s + EJ * TB3;        // [EE][TB3]
  float* Mo_s = M1_s + EE * TB3;       // [EE][TB3]: M2 (+ M3)
  const int col = threadIdx.x % TB3, grp = threadIdx.x / TB3;
  const int b0 = blockIdx.x * TB3;
  const int b = b0 + col;
  const bool live = b < B;

  for (int idx = threadIdx.x; idx < 3 * J3 * TB3; idx += NT) {
    const int c = idx % TB3, ax = idx / TB3;
    R_s[idx] = (b0 + c < B) ? Rm[(size_t)ax * B + b0 + c] : 0.f;
  }

  // term1 = Ksd : X, X[(j, k)] = sum_a R[a, j] R[a, k].
  float acc[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) acc[m] = 0.f;
  const int n_x = J3 * J3;
  for (int x0 = 0; x0 < n_x; x0 += KX) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KX * EE; idx += NT) {
      const int x = x0 + idx / EE;
      ksd_s[idx] = (x < n_x) ? ksd[(size_t)x * EE + idx % EE] : 0.f;
    }
    for (int idx = threadIdx.x; idx < KX * TB3; idx += NT) {
      const int x = x0 + idx / TB3, c = idx % TB3;
      float xv = 0.f;
      if (x < n_x) {
        const int j = x / J3, k = x % J3;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          xv = fmaf(R_s[(a * J3 + j) * TB3 + c], R_s[(a * J3 + k) * TB3 + c], xv);
      }
      X_s[idx] = xv;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KX; ++kk) {
      const float xv = X_s[kk * TB3 + col];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int r = grp + NG * m;
        if (r < EE) acc[m] = fmaf(ksd_s[kk * EE + r], xv, acc[m]);
      }
    }
  }

  // Per-column terms: thread (e = grp, col).
  const int e = grp;
  float m1[MAXE], mo[MAXE];
#pragma unroll
  for (int f = 0; f < MAXE; ++f) m1[f] = mo[f] = 0.f;
  float rbv = 0.f;
  for (int a = 0; a < 3; ++a) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < EJ * TB3; idx += NT) {
      const int c = idx % TB3, mrow = idx / TB3;
      const bool ok = b0 + c < B;
      T_s[idx] = ok ? T[((size_t)a * EJ + mrow) * B + b0 + c] : 0.f;
      P_s[idx] = (ok && has_joints) ? P[((size_t)a * EJ + mrow) * B + b0 + c] : 0.f;
    }
    __syncthreads();
    if (e < E) {
      float sa = 0.f;
      for (int j = 0; j < J; ++j) {
        // z = Z3[a, e, j] = sum_x Lz[x, e*J + j] R[a, x]
        float z = 0.f;
        for (int x = 0; x < J3; ++x)
          z = fmaf(__ldg(&lz[(size_t)x * EJ + e * J + j]), R_s[(a * J3 + x) * TB3 + col], z);
        // qt = (q T3[a, e])_j
        float qt = 0.f;
        for (int k = 0; k < J; ++k)
          qt = fmaf(__ldg(&q[j * J + k]), T_s[(e * J + k) * TB3 + col], qt);
        const float te = T_s[(e * J + j) * TB3 + col];
        const float pe = P_s[(e * J + j) * TB3 + col];
#pragma unroll
        for (int f = 0; f < MAXE; ++f) {
          if (f < E) {
            const float tf = T_s[(f * J + j) * TB3 + col];
            m1[f] = fmaf(z, tf, m1[f]);
            mo[f] = fmaf(qt, tf, mo[f]);
            mo[f] = fmaf(pe, P_s[(f * J + j) * TB3 + col], mo[f]);
          }
        }
        sa = fmaf(__ldg(&w1[j]), te, sa) + pe;
        const float yv = live ? y[((size_t)a * J + j) * B + b] : 0.f;
        const float bjv = (live && has_joints) ? bJ[((size_t)a * J + j) * B + b] : 0.f;
        rbv = fmaf(te, yv, fmaf(pe, bjv, rbv));
      }
      for (int x = 0; x < J3; ++x)
        sa = fmaf(__ldg(&sd1[x * E + e]), R_s[(a * J3 + x) * TB3 + col], sa);
      if (live) SA[((size_t)a * E + e) * B + b] = sa;
    }
  }
  if (e < E) {
#pragma unroll
    for (int f = 0; f < MAXE; ++f) {
      if (f < E) {
        M1_s[(e * E + f) * TB3 + col] = m1[f];
        Mo_s[(e * E + f) * TB3 + col] = mo[f];
      }
    }
    if (live) rb[(size_t)e * B + b] = rbv;
  }
  if (grp == NG - 1 && live) {
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
      for (int j = 0; j < J; ++j) {
        s += y[((size_t)a * J + j) * B + b];
        if (has_joints) s += bJ[((size_t)a * J + j) * B + b];
      }
      Sb[(size_t)a * B + b] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int r = grp + NG * m;
    if (r < EE && live) {
      const int re = r / E, rf = r % E;
      G[(size_t)r * B + b] = acc[m] + M1_s[r * TB3 + col] + M1_s[(rf * E + re) * TB3 + col] +
                             Mo_s[r * TB3 + col];
    }
  }
}

}  // namespace

SMPL_API size_t gram_assembly_smem_bytes(int J, int E) {
  const int J3 = 3 * J, EJ = E * J, EE = E * E;
  return sizeof(float) *
         (3 * J3 * TB3 + KX * EE + KX * TB3 + 2 * EJ * TB3 + 2 * EE * TB3);
}

// R (3, 3J, B), T (3, EJ, B), y (3, J, B), P (3, EJ, B), bJ (3, J, B) [P, bJ
// unread unless has_joints], ksd (9J^2, E^2), lz (3J, EJ), sd1 (3J, E), q (J, J),
// w1 (J,) -> G (E^2, B), SA (3E, B), rb (E, B), Sb (3, B). Requires E <= 16.
SMPL_API int gram_assembly_launch(const float* Rm, const float* T, const float* y,
                                  const float* P, const float* bJ, const float* ksd,
                                  const float* lz, const float* sd1, const float* q,
                                  const float* w1, float* G, float* SA, float* rb, float* Sb,
                                  int J, int E, int B, int has_joints, cudaStream_t stream) {
  if (E > MAXE) return (int)cudaErrorInvalidValue;
  const size_t smem = gram_assembly_smem_bytes(J, E);
  cudaError_t err = cudaFuncSetAttribute(
      gram_assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + TB3 - 1) / TB3);
  gram_assembly_kernel<<<grid, NT, smem, stream>>>(Rm, T, y, P, bJ, ksd, lz, sd1, q, w1, G, SA,
                                                   rb, Sb, J, E, B, has_joints);
  return (int)cudaGetLastError();
}
