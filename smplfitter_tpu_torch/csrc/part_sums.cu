// K5: per-part sums of a target against a per-instance reference mesh.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_part_sums_kernel
// (launcher _part_sums_impl, API part_sums_vm_lm), unweighted, for a reference
// that varies over the batch (the batch-constant reference stays one GEMM,
// models/bodyfitter.py:_part_sums_static_ref_lm). With p(v) the vertex's body
// part (one-hot membership pm), per batch column:
//     raw[c*3+d, p] = sum_v t_c a_d,  s_t[c, p] = sum_v t_c,  s_a[d, p] = sum_v a_d.
//
// What bounds it on an H100: bytes. Six floats are read per vertex and column
// and 15 FMAs or adds are done with them: at SMPL b4096 the target and the
// reference are ~677 MB, about 0.2 ms at 3.35 TB/s.
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

__global__ void __launch_bounds__(NT)
part_segments_kernel(const float* __restrict__ t, const float* __restrict__ a,
                     const int* __restrict__ verts, const int* __restrict__ seg_offset,
                     float* __restrict__ part, int B, int Vt, int Va) {
  __shared__ float red_s[NW * NS * TB4];
  const int lane = threadIdx.x % TB4, wid = threadIdx.x / TB4;
  const int b0 = blockIdx.x * TB4;
  const int b = b0 + lane;
  const bool live = b < B;
  const int seg_id = blockIdx.y;
  const int beg = seg_offset[seg_id];
  const int n = seg_offset[seg_id + 1] - beg;

  float acc[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) acc[r] = 0.f;

  for (int i0 = wid * VQ; i0 < n; i0 += NW * VQ) {
    float tq[3][VQ], aq[3][VQ];
#pragma unroll
    for (int q = 0; q < VQ; ++q) {
      const bool ok = live && i0 + q < n;
      const int v = ok ? verts[beg + i0 + q] : 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tq[c][q] = (ok && v < Vt) ? t[((size_t)c * Vt + v) * B + b] : 0.f;
        aq[c][q] = (ok && v < Va) ? a[((size_t)c * Va + v) * B + b] : 0.f;
      }
    }
    add_part_sums(acc, tq, aq);
  }
  store_warp_partials(acc, red_s, part, seg_id, b0, B);
}

}  // namespace

// t (3, Vt, B), a (3, Va, B); verts, seg_offset (n_seg + 1), part_seg (J + 1)
// as in recon_part_sums_launch -> raw (9, J, B), st (3, J, B), sa (3, J, B);
// part is scratch of n_seg * 15 * B floats.
SMPL_API int part_sums_launch(const float* t, const float* a, const int* verts,
                              const int* seg_offset, const int* part_seg, float* raw,
                              float* st, float* sa, float* part, int J, int B, int Vt, int Va,
                              int n_seg, cudaStream_t stream) {
  if (n_seg > 0) {
    dim3 grid((B + TB4 - 1) / TB4, n_seg);
    part_segments_kernel<<<grid, NT, 0, stream>>>(t, a, verts, seg_offset, part, B, Vt, Va);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_part_sum(part, part_seg, raw, st, sa, J, B, stream);
}
