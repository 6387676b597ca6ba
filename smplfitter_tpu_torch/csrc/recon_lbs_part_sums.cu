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
// homog dot, 12J of position and 15 of sums; at SMPL b4096 (F = 219, J = 24)
// about 6890 * 4096 * 960 * 2 = 54 GFLOP against ~0.35 GB read.
//
// Design: the two halves the port already has. A block owns (segment of one
// part's vertex list, 64 batch columns) and walks the segment in tiles of 64
// listed vertices with the register-blocked homog dot and blend of K1
// (lbs_tile.cuh, rows gathered through ListRows); each thread keeps the 15
// sums of its 4 columns in registers over the segment, and the block sums its
// 16 row groups in order into the segment's partial, which part_sum_kernel
// (part_segments.cuh) sums per part in segment order. No atomics. A segment's
// last tile is partly empty: its missing rows have zero weights and
// templates, so they add nothing.
#include "lbs_tile.cuh"
#include "part_segments.cuh"

using namespace lbs;

namespace {

template <bool W>
__global__ void __launch_bounds__(lbs::NT, 1)
recon_lbs_segments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                          const float* __restrict__ feat, const float* __restrict__ w,
                          const float* __restrict__ consts, const float* __restrict__ om,
                          const int* __restrict__ verts, const int* __restrict__ seg_offset,
                          float* __restrict__ part, int J, int B, int F, int Vt, int Vp,
                          int om_rows, int om_rs, int om_bs) {
  extern __shared__ float smem[];
  float* pj_s = smem;                       // [12][J][TB]
  float* w_s = pj_s + 12 * J * TB;          // [J][TVP]
  float* stage = w_s + J * TVP;             // staging_floats()
  int* rows_s = reinterpret_cast<int*>(stage + staging_floats());  // [TV]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b0 = blockIdx.x * TB;
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;

  load_pj_tile(pj_s, pj, J, B, b0);
  float acc[NS][4];
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

  for (int i0 = 0; i0 < n; i0 += TV) {
    __syncthreads();  // the previous tile is done with rows_s and w_s
    for (int vv = threadIdx.x; vv < TV; vv += lbs::NT)
      rows_s[vv] = (i0 + vv < n) ? verts[beg + i0 + vv] : -1;
    __syncthreads();
    const ListRows rows{rows_s};
    load_w_tile(w_s, w, J, rows);
    float h[3][4][4];
    homog_tile(h, feat, consts, F, B, Vp, rows, b0, stage);  // its barriers publish w_s
    float pos[3][4][4];
    pos_tile(pos, h, pj_s, w_s, J);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = rows_s[ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = b0 + tx + 16 * k;
        const bool ok = v >= 0 && v < Vt && b < B;
        float tv[3], pw[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) tv[c] = ok ? tgt[((size_t)c * Vt + v) * B + b] : 0.f;
        const float wv = W ? (ok ? fit_weight(om, v, b, Vt, om_rows, om_rs, om_bs) : 0.f) : 1.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) pw[c] = W ? pos[c][i][k] * wv : pos[c][i][k];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[c * 3 + d][k] = fmaf(tv[c], pw[d], acc[c * 3 + d][k]);
          acc[9 + c][k] = W ? fmaf(tv[c], wv, acc[9 + c][k]) : acc[9 + c][k] + tv[c];
          acc[12 + c][k] += pw[c];
        }
      }
    }
  }

  // Sum the 16 row groups (ty) of each column in order; pj_s is free now.
  __syncthreads();
  float* red = smem;  // [NS][16][TB]
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(r * 16 + ty) * TB + tx + 16 * k] = acc[r][k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS * TB; idx += lbs::NT) {
    const int r = idx / TB, c = idx % TB;
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red[(r * 16 + g) * TB + c];
    if (b0 + c < B) part[((size_t)seg_id * NS + r) * B + b0 + c] = s;
  }
}

}  // namespace

SMPL_API size_t recon_lbs_part_sums_smem_bytes(int J) {
  const int body = 12 * J * TB + J * TVP + staging_floats() + TV;
  const int red = NS * 16 * TB;
  return sizeof(float) * (body > red ? body : red);
}

template <bool W>
cudaError_t launch_segments(const float* tgt, const float* pj, const float* feat, const float* w,
                            const float* consts, const float* om, const int* verts,
                            const int* seg_offset, float* part, int J, int B, int F, int Vt,
                            int Vp, int n_seg, int om_rows, int om_rs, int om_bs,
                            cudaStream_t stream) {
  const size_t smem = recon_lbs_part_sums_smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(
      recon_lbs_segments_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB - 1) / TB, n_seg);
  recon_lbs_segments_kernel<W><<<grid, lbs::NT, smem, stream>>>(
      tgt, pj, feat, w, consts, om, verts, seg_offset, part, J, B, F, Vt, Vp, om_rows, om_rs,
      om_bs);
  return cudaGetLastError();
}

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F);
// om null or fit weights, verts, seg_offset (n_seg + 1), part_seg (J + 1) as
// in recon_part_sums_launch -> raw (9, J, B), st (3, J, B), sa (3, J, B);
// part is scratch of n_seg * 15 * B floats.
SMPL_API int recon_lbs_part_sums_launch(const float* tgt, const float* pj, const float* feat,
                                        const float* w, const float* consts, const float* om,
                                        const int* verts, const int* seg_offset,
                                        const int* part_seg, float* raw, float* st, float* sa,
                                        float* part, int J, int B, int F, int Vt, int Vp,
                                        int n_seg, int om_rows, int om_rs, int om_bs,
                                        cudaStream_t stream) {
  if (n_seg > 0) {
    const cudaError_t err =
        om == nullptr
            ? launch_segments<false>(tgt, pj, feat, w, consts, om, verts, seg_offset, part, J,
                                     B, F, Vt, Vp, n_seg, om_rows, om_rs, om_bs, stream)
            : launch_segments<true>(tgt, pj, feat, w, consts, om, verts, seg_offset, part, J,
                                    B, F, Vt, Vp, n_seg, om_rows, om_rs, om_bs, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
