// K5: per-part sums of a target against a per-instance reference mesh.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_part_sums_kernel
// (launcher _part_sums_impl, API part_sums_vm_lm). With p(v) the vertex's body
// part (one-hot membership pm), per batch column:
//     raw[c*3+d, p] = sum_v t_c a_d,  s_t[c, p] = sum_v t_c,  s_a[d, p] = sum_v a_d.
// The fit-weighted form (W) takes ω per vertex, the static column (V_pad, 1)
// or per-call weights (V, B), through one row and one batch stride, and
// multiplies a in every sum and t in s_t (the JAX package's convention). The
// reference may be batch-constant (BCAST: (3, V_a, 1), read with a batch
// stride of 0): under per-call weights the first rotation fit's T-pose; the
// fit sends the unweighted and static forms of that case to one GEMM
// (models/bodyfitter.py:_part_sums_static_ref_lm), and they reach this
// kernel only through the API.
//
// What bounds it on an H100: bytes. Six floats are read per vertex and column
// (seven weighted) and 15 FMAs or adds are done with them: at SMPL b4096 the
// target and the reference are ~677 MB, about 0.2 ms at 3.35 TB/s.
//
// Design: the TPU kernel ran the membership as a (J x VC) matrix product per
// vertex chunk. Here the membership's one-hot structure does the work
// (part_segments.cuh): a block owns (segment, 32 batch columns), each warp
// reads 4 vertices at a time as full 128-byte rows of the batch-contiguous
// (3, V, B) operands, one column per lane, and keeps the 15 sums in
// registers. Vertices outside every part are never read. The target's and the
// reference's vertex edges (V_t, V_a rows) and the batch edge are masked.
#include "part_segments.cuh"

using namespace seg;

namespace {

template <bool W, bool BCAST>
__global__ void __launch_bounds__(NT)
part_segments_kernel(const float* __restrict__ t, const float* __restrict__ a,
                     const float* __restrict__ om, const int* __restrict__ verts,
                     const int* __restrict__ seg_offset, float* __restrict__ part, int B, int Vt,
                     int Va, int om_rows, int om_rs, int om_bs) {
  __shared__ float red_s[NW * NS * TB4];
  const int lane = threadIdx.x % TB4, wid = threadIdx.x / TB4;
  const int b0 = blockIdx.x * TB4;
  const int b = b0 + lane;
  const bool live = b < B;
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;
  const int a_ld = BCAST ? 1 : B;  // the reference's row stride and batch index
  const int a_b = BCAST ? 0 : b;

  float acc[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) acc[r] = 0.f;

  for (int i0 = wid * VQ; i0 < n; i0 += NW * VQ) {
    float tq[3][VQ], aq[3][VQ], wq[VQ];
#pragma unroll
    for (int q = 0; q < VQ; ++q) {
      const bool ok = live && i0 + q < n;
      const int v = ok ? verts[beg + i0 + q] : 0;
      if (W) wq[q] = ok ? fit_weight(om, v, b, Vt, om_rows, om_rs, om_bs) : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tq[c][q] = (ok && v < Vt) ? t[((size_t)c * Vt + v) * B + b] : 0.f;
        aq[c][q] = (ok && v < Va) ? a[((size_t)c * Va + v) * a_ld + a_b] : 0.f;
        if (W) aq[c][q] *= wq[q];
      }
    }
    if (W) add_part_sums_w(acc, tq, aq, wq);
    else add_part_sums(acc, tq, aq);
  }
  store_warp_partials(acc, red_s, part, seg_id, b0, B);
}

}  // namespace

// t (3, Vt, B), a (3, Va, B) or with bcast (3, Va, 1); om null, or the fit
// weights read as om[v * om_rs + b * om_bs] for v < min(Vt, om_rows); verts,
// seg_offset (n_seg + 1), part_seg (J + 1) as in recon_part_sums_launch ->
// raw (9, J, B), st (3, J, B), sa (3, J, B); part is scratch of
// n_seg * 15 * B floats.
SMPL_API int part_sums_launch(const float* t, const float* a, const float* om, const int* verts,
                              const int* seg_offset, const int* part_seg, float* raw,
                              float* st, float* sa, float* part, int J, int B, int Vt, int Va,
                              int n_seg, int bcast, int om_rows, int om_rs, int om_bs,
                              cudaStream_t stream) {
  if (n_seg > 0) {
    dim3 grid((B + TB4 - 1) / TB4, n_seg);
    if (om == nullptr && bcast)
      part_segments_kernel<false, true><<<grid, NT, 0, stream>>>(
          t, a, om, verts, seg_offset, part, B, Vt, Va, om_rows, om_rs, om_bs);
    else if (om == nullptr)
      part_segments_kernel<false, false><<<grid, NT, 0, stream>>>(
          t, a, om, verts, seg_offset, part, B, Vt, Va, om_rows, om_rs, om_bs);
    else if (bcast)
      part_segments_kernel<true, true><<<grid, NT, 0, stream>>>(
          t, a, om, verts, seg_offset, part, B, Vt, Va, om_rows, om_rs, om_bs);
    else
      part_segments_kernel<true, false><<<grid, NT, 0, stream>>>(
          t, a, om, verts, seg_offset, part, B, Vt, Va, om_rows, om_rs, om_bs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
