// K6: reconstruction by extended LBS, fused into per-part sums.
//
// Replaces the TPU kernel
// smplfitter_tpu/ops/lbs_kernels.py:_recon_part_sums_kernel (launcher
// _recon_part_sums_impl, API recon_part_sums_lm), unweighted. It is K4
// without the posed-template cache: per vertex v and batch column the
// homogeneous template homog_c = consts_c . feat (an F-deep dot, F = 207 + 1
// + E at SMPL), pos = blended [R|t] . homog, and with p(v) the vertex's body
// part, raw[c*3+d, p] += t_c pos_d, s_t[c, p] += t_c, s_a[d, p] += pos_d. The
// reconstructed mesh never reaches device memory, as on the TPU. The
// fit-weighted form (W) multiplies pos by ω in every sum and t by ω in s_t,
// ω the static column (V_pad, 1) or per-call weights (V, B)
// (part_segments.cuh:fit_weight).
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): 3F FMAs of
// the template dot, 12 per joint that skins the vertex of the blend and 15
// of the sums; at SMPL-X b4096 (F = 503, 3 joints per vertex) about 10475 *
// 4096 * 1560 * 2 = 134 GFLOP against ~0.25 GB read.
//
// Design: a block owns (segment of one part's vertex list, 128 batch
// columns) and walks the segment in tiles of 32 listed vertices.
// - The template dot is a register-tiled GEMM (the pattern of
//   sgemm_tile.cuh): each thread owns 4 vertices x 4 columns x 3 channels,
//   and per feature reads three float4 of the consts stage (4 vertices, one
//   per channel) and one of the feat stage (4 columns): 48 FMAs per 4 shared
//   loads, broadcasts within a warp (4 x 8 threads). Features go 16 at a
//   time through a 4-stage cp.async ring that runs on across tile
//   boundaries, so the next tile's first stages load while this tile's
//   blend and sums run. consts rows are gathered through the segment's vertex
//   list, each element by a 4-byte copy to its k-major place (F is odd: no
//   16-byte copy fits), a warp copying 8 features of 4 rows into 32 banks;
//   feat by 16-byte copies where B % 4 == 0.
// - The blend runs over the segment's active joints only (the joints with a
//   nonzero weight on any of its vertices, listed by the host with the part
//   index: PartIndex in ops/lbs_kernels.py); the terms left out are products
//   with exact zeros. The joints' [R|t] entries and weights are read from
//   global memory (L1) as they are used: a long list (dense weights) runs
//   the same loop.
// - The 15 sums of each thread's 4 columns stay in registers over the
//   segment; the block sums its 8 vertex groups in order into the segment's
//   partial, which part_sum_kernel (part_segments.cuh) sums per part in
//   segment order. No atomics: runs repeat bit for bit. A tile's rows past
//   the segment gather nothing (zero fill) and carry zero weights.
#include "part_segments.cuh"
#include "sgemm_tile.cuh"

namespace {

constexpr int K6_NT = 256;
constexpr int TV = 32;               // listed vertices per tile
constexpr int TB = 128;              // batch columns per block
constexpr int KT = 16;               // features per k tile
constexpr int NSTG = 4;              // stages of the copy ring
constexpr int LDA = TV + 4;          // row stride of the k-major consts stage
constexpr int A_FLOATS = 3 * KT * LDA;  // [c][k][LDA]
constexpr int B_FLOATS = KT * TB;       // [k][TB]
constexpr int STG_FLOATS = A_FLOATS + B_FLOATS;
constexpr int SEG_MAX = 512;         // vertices per segment at most (PartIndex)
constexpr int RED_FLOATS = NS * 8 * TB;  // [NS][vertex group][TB]
constexpr int BODY_FLOATS = NSTG * STG_FLOATS;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (BODY_FLOATS > RED_FLOATS ? BODY_FLOATS : RED_FLOATS) + sizeof(int) * SEG_MAX;

// consts copies: a warp covers 8 features of 4 rows, the block 16 rows (of
// the 3 TV rows (c, vertex)) per pass.
constexpr int A_ROWS_PER_PASS = 16;
constexpr int A_PASSES = 3 * TV / A_ROWS_PER_PASS;  // 6
constexpr int B_PASSES = B_FLOATS / 4 / K6_NT;      // 2 float4 copies per thread

// VEC: B % 4 == 0 and 16-byte aligned feat, pj, tgt (and per-call ω):
// float4 copies and loads; else 4-byte ones.
template <bool VEC, bool W>
__global__ void __launch_bounds__(K6_NT, 1)
recon_lbs_segments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                          const float* __restrict__ feat, const float* __restrict__ w,
                          const float* __restrict__ consts, const float* __restrict__ om,
                          const int* __restrict__ verts, const int* __restrict__ seg_offset,
                          const int* __restrict__ joints, const int* __restrict__ joint_offset,
                          float* __restrict__ part, int J, int B, int F, int Vt, int Vp,
                          int om_rows, int om_rs, int om_bs) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);  // [NSTG][A | B]
  const int body = BODY_FLOATS > RED_FLOATS ? BODY_FLOATS : RED_FLOATS;
  int* const rows_s = reinterpret_cast<int*>(ring + body);  // [SEG_MAX]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = 4 * (warp / 4) + lane / 8;   // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 8 * (warp % 4) + lane % 8;   // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;                 // the thread's first column
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;
  const int j0 = joint_offset[seg_id], nA = joint_offset[seg_id + 1] - j0;
  const int n_tiles = (n + TV - 1) / TV, nk = (F + KT - 1) / KT;

  for (int i = threadIdx.x; i < SEG_MAX; i += K6_NT) rows_s[i] = i < n ? verts[beg + i] : -1;
  __syncthreads();

  // The thread's consts copies: feature ka of rows ra + 16 q (q < 6); feat
  // copies: columns 4 cb .. 4 cb + 3 of features kb + 8 q (q < 2).
  const int ka = 8 * (warp % 2) + lane % 8;
  const int ra = 4 * (warp / 2) + lane / 8;
  const int kb = threadIdx.x / (TB / 4), cb = threadIdx.x % (TB / 4);
  const bool live_b = b0 + 4 * cb < B;

  auto issue = [&](int step) {
    const int tile = step / nk, f0 = (step % nk) * KT;
    float* as = ring + (step % NSTG) * STG_FLOATS;
    float* bs = as + A_FLOATS;
    const bool live_k = f0 + ka < F;
#pragma unroll
    for (int q = 0; q < A_PASSES; ++q) {
      const int row = ra + A_ROWS_PER_PASS * q;  // (c, vertex) = (row / TV, row % TV)
      const int c = row / TV, vv = row % TV;
      const int v = rows_s[tile * TV + vv];
      const bool live = live_k && v >= 0;
      sgemm::cp_async4(as + (c * KT + ka) * LDA + vv,
                       live ? consts + ((size_t)c * Vp + v) * F + f0 + ka : consts, live);
    }
    if (VEC) {
#pragma unroll
      for (int q = 0; q < B_PASSES; ++q) {
        const int k = kb + (K6_NT / (TB / 4)) * q;
        const bool live = live_b && f0 + k < F;
        sgemm::cp_async16(bs + k * TB + 4 * cb,
                          live ? feat + (size_t)(f0 + k) * B + b0 + 4 * cb : feat, live);
      }
    } else {
      for (int e = threadIdx.x; e < B_FLOATS; e += K6_NT) {
        const int k = e / TB, bb = e % TB;
        const bool live = f0 + k < F && b0 + bb < B;
        sgemm::cp_async4(bs + e, live ? feat + (size_t)(f0 + k) * B + b0 + bb : feat, live);
      }
    }
  };

  float acc[NS][4];
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
  float h[3][4][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) h[c][i][k] = 0.f;

  const int n_steps = n_tiles * nk;
#pragma unroll
  for (int st = 0; st < NSTG - 1; ++st) {
    if (st < n_steps) issue(st);
    sgemm::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    // Step `step` has landed; step - 1 is consumed, so its slot takes step + NSTG - 1.
    sgemm::cp_async_wait<NSTG - 2>();
    __syncthreads();
    if (step + NSTG - 1 < n_steps) issue(step + NSTG - 1);
    sgemm::cp_async_commit();
    const float* as = ring + (step % NSTG) * STG_FLOATS;
    const float* bs = as + A_FLOATS;
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 fb = *reinterpret_cast<const float4*>(bs + k * TB + 4 * tn);
      const float fv[4] = {fb.x, fb.y, fb.z, fb.w};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 cv4 = *reinterpret_cast<const float4*>(as + (c * KT + k) * LDA + 4 * tm);
        const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) h[c][i][kk] = fmaf(cv[i], fv[kk], h[c][i][kk]);
      }
    }
    if ((step + 1) % nk != 0) continue;

    // The tile's template is complete: blend over the active joints, then sums.
    const int tile = step / nk;
    int vid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vid[i] = rows_s[tile * TV + 4 * tm + i];
    float pos[3][4][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) pos[a][i][k] = 0.f;
    for (int jj = 0; jj < nA; ++jj) {
      const int j = joints[j0 + jj];
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = vid[i] >= 0 ? __ldg(w + (size_t)vid[i] * J + j) : 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float p[4][4];  // [c][column]: entries a*4 + c of the 4 columns
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* src = pj + ((size_t)(a * 4 + c) * J + j) * B + bc;
          if (VEC) {
            const float4 v4 = bc < B ? __ldg(reinterpret_cast<const float4*>(src))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            p[c][0] = v4.x;
            p[c][1] = v4.y;
            p[c][2] = v4.z;
            p[c][3] = v4.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) p[c][k] = bc + k < B ? __ldg(src + k) : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float t = fmaf(p[0][k], h[0][i][k],
                            fmaf(p[1][k], h[1][i][k], fmaf(p[2][k], h[2][i][k], p[3][k])));
            pos[a][i][k] = fmaf(wv[i], t, pos[a][i][k]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = vid[i];
      float tv[3][4], wk[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* src = tgt + ((size_t)c * Vt + (v >= 0 ? v : 0)) * B + bc;
        const bool row_ok = v >= 0 && v < Vt;
        if (VEC) {
          const float4 v4 = row_ok && bc < B ? __ldg(reinterpret_cast<const float4*>(src))
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
          tv[c][0] = v4.x;
          tv[c][1] = v4.y;
          tv[c][2] = v4.z;
          tv[c][3] = v4.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) tv[c][k] = row_ok && bc + k < B ? __ldg(src + k) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wk[k] = W ? (v >= 0 && bc + k < B ? fit_weight(om, v, bc + k, Vt, om_rows, om_rs, om_bs)
                                          : 0.f)
                  : 1.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float pw[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) pw[c] = W ? pos[c][i][k] * wk[k] : pos[c][i][k];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[c * 3 + d][k] = fmaf(tv[c][k], pw[d], acc[c * 3 + d][k]);
          acc[9 + c][k] = W ? fmaf(tv[c][k], wk[k], acc[9 + c][k]) : acc[9 + c][k] + tv[c][k];
          acc[12 + c][k] += pw[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) h[c][i][k] = 0.f;
  }

  // Sum the 8 vertex groups (tm) of each column in order; the ring is free.
  sgemm::cp_async_wait<0>();
  __syncthreads();
  float* red = ring;  // [NS][8][TB]
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(r * 8 + tm) * TB + 4 * tn + k] = acc[r][k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS * TB; idx += K6_NT) {
    const int r = idx / TB, c = idx % TB;
    float s = 0.f;
    for (int g = 0; g < 8; ++g) s += red[(r * 8 + g) * TB + c];
    if (b0 + c < B) part[((size_t)seg_id * NS + r) * B + b0 + c] = s;
  }
}

template <bool VEC, bool W>
cudaError_t launch_segments(const float* tgt, const float* pj, const float* feat, const float* w,
                            const float* consts, const float* om, const int* verts,
                            const int* seg_offset, const int* joints, const int* joint_offset,
                            float* part, int J, int B, int F, int Vt, int Vp, int n_seg,
                            int om_rows, int om_rs, int om_bs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(recon_lbs_segments_kernel<VEC, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, n_seg);
  recon_lbs_segments_kernel<VEC, W><<<grid, K6_NT, SMEM_BYTES, stream>>>(
      tgt, pj, feat, w, consts, om, verts, seg_offset, joints, joint_offset, part, J, B, F, Vt,
      Vp, om_rows, om_rs, om_bs);
  return cudaGetLastError();
}

}  // namespace

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F);
// om null or fit weights, verts, seg_offset (n_seg + 1; segments of at most
// 512 vertices), joints and joint_offset (n_seg + 1: each segment's active
// joints), part_seg (J + 1) as in recon_part_sums_launch -> raw (9, J, B),
// st (3, J, B), sa (3, J, B); part is scratch of n_seg * 15 * B floats.
SMPL_API int recon_lbs_part_sums_launch(const float* tgt, const float* pj, const float* feat,
                                        const float* w, const float* consts, const float* om,
                                        const int* verts, const int* seg_offset,
                                        const int* joints, const int* joint_offset,
                                        const int* part_seg, float* raw, float* st, float* sa,
                                        float* part, int J, int B, int F, int Vt, int Vp,
                                        int n_seg, int om_rows, int om_rs, int om_bs,
                                        cudaStream_t stream) {
  if (n_seg > 0) {
    const bool vec = B % 4 == 0 && sgemm::aligned16(feat) && sgemm::aligned16(pj) &&
                     sgemm::aligned16(tgt);
    cudaError_t err;
#define K6_CASE(v, wt)                                                                    \
  err = launch_segments<v, wt>(tgt, pj, feat, w, consts, om, verts, seg_offset, joints,   \
                               joint_offset, part, J, B, F, Vt, Vp, n_seg, om_rows, om_rs, \
                               om_bs, stream);
    if (vec) {
      if (om == nullptr) { K6_CASE(true, false) } else { K6_CASE(true, true) }
    } else {
      if (om == nullptr) { K6_CASE(false, false) } else { K6_CASE(false, true) }
    }
#undef K6_CASE
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
