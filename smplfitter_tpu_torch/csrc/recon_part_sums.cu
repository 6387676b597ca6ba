// K4: reconstruction from the cached posed template, fused into per-part sums.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_recon_cached_kernel
// (launcher _recon_cached_impl, API recon_part_sums_cached_lm). Per vertex v
// and batch column: hfull_c = homog_c + SD_v[c, :] . x, pos = blended [R|t] .
// hfull, and with p(v) the vertex's body part (one-hot membership pm),
//     raw[c*3+d, p, :] += t_c pos_d,  s_t[c, p, :] += t_c,  s_a[d, p, :] += pos_d.
// The fit-weighted form (W) multiplies pos by ω in every sum and t by ω in
// s_t, ω the static column (V_pad, 1) or per-call weights (V, B), read
// through a row and a batch stride (part_segments.cuh:fit_weight).
//
// What bounds it on an H100: f32 arithmetic of the blend (12J FMAs per vertex
// and column; ~19 GFLOP at SMPL b4096), fed from shared memory; the cached
// template and the targets are read once (~0.2 GB).
//
// Design: pm is one-hot over vertices, so instead of a (J x V) membership
// product every vertex adds into exactly one part (part_segments.cuh): a block
// owns (segment, 32 batch columns), keeps the batch tile's [R|t] entries in
// shared memory, and each of its 8 warps walks every 8th group of 4 vertices
// with the 15 per-part sums in registers (one batch column per lane). Vertices
// outside every part cost nothing. The batch edge is masked, so any B works.
// The shape solve's coefficients x stay in registers: the kernel is
// instantiated for E <= 16 and E <= 32 (SMPL-X with the kid column is E = 17)
// and the launcher picks the smaller instance that holds E: on an H100 the
// E <= 32 instance alone took 1.4x the time of the E <= 16 one on SMPL (E = 10).
#include "part_segments.cuh"

using namespace seg;

namespace {

template <int MAXE, bool W>
__global__ void __launch_bounds__(NT)
recon_segments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                      const float* __restrict__ x, const float* __restrict__ sd,
                      const float* __restrict__ homog, const float* __restrict__ w,
                      const float* __restrict__ om, const int* __restrict__ verts,
                      const int* __restrict__ seg_offset, float* __restrict__ part, int J, int E,
                      int B, int Vt, int Vp, int om_rows, int om_rs, int om_bs) {
  extern __shared__ float smem[];
  float* pj_s = smem;                 // [12][J][TB4]
  float* red_s = pj_s + 12 * J * TB4; // [NW][NS][TB4]
  const int lane = threadIdx.x % TB4, wid = threadIdx.x / TB4;
  const int b0 = blockIdx.x * TB4;
  const int b = b0 + lane;
  const bool live = b < B;
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;

  for (int idx = threadIdx.x; idx < 12 * J * TB4; idx += NT) {
    const int c = idx % TB4, xj = idx / TB4;
    pj_s[idx] = (b0 + c < B) ? pj[(size_t)xj * B + b0 + c] : 0.f;
  }
  float xr[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) xr[e] = (e < E && live) ? x[(size_t)e * B + b] : 0.f;
  __syncthreads();

  float acc[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) acc[r] = 0.f;

  for (int i0 = wid * VQ; i0 < n; i0 += NW * VQ) {
    int vq[VQ];
    bool okq[VQ];
#pragma unroll
    for (int q = 0; q < VQ; ++q) {
      okq[q] = i0 + q < n;
      vq[q] = okq[q] ? verts[beg + i0 + q] : 0;
    }
    float hf[3][VQ], tq[3][VQ];
#pragma unroll
    for (int q = 0; q < VQ; ++q) {
      const int v = vq[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float hv = live ? homog[((size_t)c * Vp + v) * B + b] : 0.f;
        const float* sdv = sd + ((size_t)c * Vp + v) * E;
#pragma unroll
        for (int e = 0; e < MAXE; ++e)
          if (e < E) hv = fmaf(__ldg(&sdv[e]), xr[e], hv);
        hf[c][q] = hv;
        tq[c][q] = (live && okq[q] && v < Vt) ? tgt[((size_t)c * Vt + v) * B + b] : 0.f;
      }
    }
    float pos[3][VQ];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int q = 0; q < VQ; ++q) pos[a][q] = 0.f;
    for (int j = 0; j < J; ++j) {
      float wq[VQ];
#pragma unroll
      for (int q = 0; q < VQ; ++q) wq[q] = okq[q] ? __ldg(&w[(size_t)vq[q] * J + j]) : 0.f;
      float p[12];
#pragma unroll
      for (int xx = 0; xx < 12; ++xx) p[xx] = pj_s[(xx * J + j) * TB4 + lane];
#pragma unroll
      for (int q = 0; q < VQ; ++q)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float t = fmaf(p[a * 4 + 0], hf[0][q],
                          fmaf(p[a * 4 + 1], hf[1][q],
                          fmaf(p[a * 4 + 2], hf[2][q], p[a * 4 + 3])));
          pos[a][q] = fmaf(wq[q], t, pos[a][q]);
        }
    }
    if (W) {
      float wq[VQ];
#pragma unroll
      for (int q = 0; q < VQ; ++q) {
        wq[q] = (live && okq[q]) ? fit_weight(om, vq[q], b, Vt, om_rows, om_rs, om_bs) : 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) pos[a][q] *= wq[q];
      }
      add_part_sums_w(acc, tq, pos, wq);
    } else {
      add_part_sums(acc, tq, pos);
    }
  }
  store_warp_partials(acc, red_s, part, seg_id, b0, B);
}

template <int MAXE, bool W>
cudaError_t launch_segments(const float* tgt, const float* pj, const float* x, const float* sd,
                            const float* homog, const float* w, const float* om,
                            const int* verts, const int* seg_offset, float* part, int J, int E,
                            int B, int Vt, int Vp, int n_seg, int om_rows, int om_rs, int om_bs,
                            size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      recon_segments_kernel<MAXE, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TB4 - 1) / TB4, n_seg);
  recon_segments_kernel<MAXE, W><<<grid, NT, smem, stream>>>(
      tgt, pj, x, sd, homog, w, om, verts, seg_offset, part, J, E, B, Vt, Vp, om_rows, om_rs,
      om_bs);
  return cudaGetLastError();
}

template <int MAXE>
cudaError_t launch_form(const float* tgt, const float* pj, const float* x, const float* sd,
                        const float* homog, const float* w, const float* om, const int* verts,
                        const int* seg_offset, float* part, int J, int E, int B, int Vt, int Vp,
                        int n_seg, int om_rows, int om_rs, int om_bs, size_t smem,
                        cudaStream_t stream) {
  return om == nullptr
             ? launch_segments<MAXE, false>(tgt, pj, x, sd, homog, w, om, verts, seg_offset,
                                            part, J, E, B, Vt, Vp, n_seg, om_rows, om_rs, om_bs,
                                            smem, stream)
             : launch_segments<MAXE, true>(tgt, pj, x, sd, homog, w, om, verts, seg_offset,
                                           part, J, E, B, Vt, Vp, n_seg, om_rows, om_rs, om_bs,
                                           smem, stream);
}

}  // namespace

SMPL_API size_t recon_part_sums_smem_bytes(int J) {
  return sizeof(float) * (12 * J * TB4 + NW * NS * TB4);
}

// tgt (3, Vt, B), pj (12, J, B), x (E, B), sd (3, Vp, E), homog (3, Vp, B),
// w (Vp, J); om null, or the fit weights read as om[v * om_rs + b * om_bs]
// for v < min(Vt, om_rows); verts: the used vertices grouped by part;
// seg_offset (n_seg + 1): segment bounds in verts; part_seg (J + 1): each
// part's segment range -> raw (9, J, B), st (3, J, B), sa (3, J, B); part is
// scratch of n_seg * 15 * B floats. Requires E <= 32.
SMPL_API int recon_part_sums_launch(const float* tgt, const float* pj, const float* x,
                                    const float* sd, const float* homog, const float* w,
                                    const float* om, const int* verts, const int* seg_offset,
                                    const int* part_seg, float* raw, float* st, float* sa,
                                    float* part, int J, int E, int B, int Vt, int Vp,
                                    int n_seg, int om_rows, int om_rs, int om_bs,
                                    cudaStream_t stream) {
  if (E > 32) return (int)cudaErrorInvalidValue;
  if (n_seg > 0) {
    const size_t smem = recon_part_sums_smem_bytes(J);
    const cudaError_t err =
        E <= 16 ? launch_form<16>(tgt, pj, x, sd, homog, w, om, verts, seg_offset, part, J, E,
                                  B, Vt, Vp, n_seg, om_rows, om_rs, om_bs, smem, stream)
                : launch_form<32>(tgt, pj, x, sd, homog, w, om, verts, seg_offset, part, J, E,
                                  B, Vt, Vp, n_seg, om_rows, om_rs, om_bs, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
