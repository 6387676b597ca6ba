// K15: the backward pass of K5 (per-part sums against a reference mesh).
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_part_sums_bwd_kernel
// (launcher _part_sums_bwd; the VJPs _part_sums_diff / _part_sums_w_diff). K5
// sums, per body part p and batch column, raw[c*3+d, p] of t_c a_d, s_t[c, p]
// of t_c and s_a[d, p] of a_d over the part's vertices; the fit-weighted form
// takes a ω and t ω in place of a and t (ω the static column, zero past the
// targets' rows). With the cotangents graw (9, J, B), gst and gsa (3, J, B)
// read at the vertex's own part row (the membership is one-hot, so W =
// graw[:, p(v)] is a gather, no product over the joints):
//     dt_c = ω (gst[c, p] + sum_d W[c*3+d] a_d)                 (3, V_t, B)
//     da_d = ω (gsa[d, p] + sum_c W[c*3+d] t_c)                 (3, V_a, B)
// and for a batch-constant reference a (3, V_a, 1) (SUM; s_a and gsa are then
// (3, J, 1)) da_d = ω (gsa[d, p] + sum_b sum_c W[c*3+d] t_c), (3, V_a, 1). A
// vertex outside every part gets zeros; t is zero past its V_t rows and a past
// its V_a rows, masked by global row index.
//
// What bounds it on an H100: bytes. Per (vertex, column) it reads t and a (6
// floats) and writes dt and da (6) around 18 FMAs; the 15 cotangents of a
// (part, column) are gathered through the cache (15 J B floats, 5.9 MB at
// SMPL b4096). At SMPL b4096 the four (3, V, B) arrays are 1.35 GB, ~0.40 ms
// at 3.35 TB/s.
//
// Design: one thread per (vertex, column); a warp walks 32 consecutive columns
// of one vertex, so each of its reads and writes is a full 128-byte row. The
// summed form gives each block a split of 256 columns: a lane adds its 8
// columns, the warp adds its lanes by shuffles in a fixed tree, and lane 0
// writes the split's partial (n_splits, 3, V_a); part_sums_bwd_sum_kernel adds
// the splits in order, then the part's gsa, then applies ω. No atomics: two
// runs give the same bits.
#include <cuda_runtime.h>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int LANES = 32;       // columns per warp step
constexpr int VY = 8;           // vertices per block, one warp each
constexpr int SUM_COLS = 256;   // columns per split of the summed form

// The static fit weight of vertex v (the column (V_pad, 1)), zero past the
// targets' rows.
__device__ inline float static_weight(const float* __restrict__ om, int v, int Vt) {
  return v < Vt ? om[v] : 0.f;
}

template <bool W, bool SUM>
__global__ void __launch_bounds__(LANES * VY)
part_sums_bwd_kernel(const float* __restrict__ graw, const float* __restrict__ gst,
                     const float* __restrict__ gsa, const float* __restrict__ t,
                     const float* __restrict__ a, const float* __restrict__ om,
                     const int* __restrict__ vpart, float* __restrict__ dt,
                     float* __restrict__ da, float* __restrict__ part, int J, int B, int Vt,
                     int Va) {
  const int lane = threadIdx.x;
  const int v = blockIdx.y * VY + threadIdx.y;
  if (v >= (Vt > Va ? Vt : Va)) return;  // uniform across the warp
  const int p = vpart[v];
  const float wv = W ? static_weight(om, v, Vt) : 1.f;
  const int b_beg = blockIdx.x * (SUM ? SUM_COLS : LANES);
  const int b_end = min(B, b_beg + (SUM ? SUM_COLS : LANES));
  float a_const[3] = {0.f, 0.f, 0.f};  // the batch-constant reference's row
  if (SUM && p >= 0 && v < Va) {
#pragma unroll
    for (int d = 0; d < 3; ++d) a_const[d] = a[(size_t)d * Va + v];
  }
  float acc[3] = {0.f, 0.f, 0.f};
  for (int b = b_beg + lane; b < b_end; b += LANES) {
    float dtv[3] = {0.f, 0.f, 0.f}, dav[3] = {0.f, 0.f, 0.f};
    if (p >= 0) {
      float tc[3], ad[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tc[c] = v < Vt ? t[((size_t)c * Vt + v) * B + b] : 0.f;
        ad[c] = SUM ? a_const[c] : (v < Va ? a[((size_t)c * Va + v) * B + b] : 0.f);
        dtv[c] = __ldg(&gst[((size_t)c * J + p) * B + b]);
        if (!SUM) dav[c] = __ldg(&gsa[((size_t)c * J + p) * B + b]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float wcd = __ldg(&graw[((size_t)(c * 3 + d) * J + p) * B + b]);
          dtv[c] = fmaf(wcd, ad[d], dtv[c]);
          dav[d] = fmaf(wcd, tc[c], dav[d]);
        }
    }
    if (v < Vt) {
#pragma unroll
      for (int c = 0; c < 3; ++c) dt[((size_t)c * Vt + v) * B + b] = dtv[c] * wv;
    }
    if (SUM) {
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d] += dav[d];
    } else if (v < Va) {
#pragma unroll
      for (int d = 0; d < 3; ++d) da[((size_t)d * Va + v) * B + b] = dav[d] * wv;
    }
  }
  if (SUM) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
      for (int off = LANES / 2; off > 0; off >>= 1)
        acc[d] += __shfl_down_sync(0xffffffffu, acc[d], off);
    if (lane == 0 && v < Va) {
#pragma unroll
      for (int d = 0; d < 3; ++d) part[((size_t)blockIdx.x * 3 + d) * Va + v] = acc[d];
    }
  }
}

// da[d, v] = ω (gsa[d, p(v)] + sum over splits of part[split, d, v]), the
// splits in order; gsa is (3, J, 1).
template <bool W>
__global__ void part_sums_bwd_sum_kernel(const float* __restrict__ part,
                                         const float* __restrict__ gsa,
                                         const float* __restrict__ om,
                                         const int* __restrict__ vpart, float* __restrict__ da,
                                         int J, int Vt, int Va, int n_splits) {
  const int n = 3 * Va;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int d = idx / Va, v = idx % Va;
    const int p = vpart[v];
    float s = 0.f;
    if (p >= 0) {
      for (int sp = 0; sp < n_splits; ++sp) s += part[((size_t)sp * 3 + d) * Va + v];
      s = gsa[(size_t)d * J + p] + s;
    }
    da[idx] = s * (W ? static_weight(om, v, Vt) : 1.f);
  }
}

template <bool W>
cudaError_t launch_variant(const float* graw, const float* gst, const float* gsa,
                           const float* t, const float* a, const float* om, const int* vpart,
                           float* dt, float* da, float* part, int J, int B, int Vt, int Va,
                           int sum, cudaStream_t stream) {
  const int n = Vt > Va ? Vt : Va;
  const dim3 block(LANES, VY);
  if (!sum) {
    const dim3 grid((B + LANES - 1) / LANES, (n + VY - 1) / VY);
    part_sums_bwd_kernel<W, false><<<grid, block, 0, stream>>>(graw, gst, gsa, t, a, om, vpart,
                                                               dt, da, part, J, B, Vt, Va);
    return cudaGetLastError();
  }
  const int n_splits = (B + SUM_COLS - 1) / SUM_COLS;
  const dim3 grid(n_splits, (n + VY - 1) / VY);
  part_sums_bwd_kernel<W, true><<<grid, block, 0, stream>>>(graw, gst, gsa, t, a, om, vpart, dt,
                                                            da, part, J, B, Vt, Va);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  part_sums_bwd_sum_kernel<W><<<(3 * Va + threads - 1) / threads, threads, 0, stream>>>(
      part, gsa, om, vpart, da, J, Vt, Va, n_splits);
  return cudaGetLastError();
}

}  // namespace

// graw (9, J, B), gst (3, J, B), gsa (3, J, B) or with sum (3, J, 1), t (3, Vt,
// B), a (3, Va, B) or with sum (3, Va, 1), om null or the static fit weights
// (Vp, 1), vpart (>= max(Vt, Va)) int32: each vertex's part or -1 -> dt (3, Vt,
// B), da (3, Va, B) or with sum (3, Va, 1). part: with sum, scratch of
// ceil(B / 256) * 3 * Va floats (unused otherwise).
SMPL_API int part_sums_bwd_launch(const float* graw, const float* gst, const float* gsa,
                                  const float* t, const float* a, const float* om,
                                  const int* vpart, float* dt, float* da, float* part, int J,
                                  int B, int Vt, int Va, int sum, cudaStream_t stream) {
  const cudaError_t err =
      om == nullptr
          ? launch_variant<false>(graw, gst, gsa, t, a, om, vpart, dt, da, part, J, B, Vt, Va,
                                  sum, stream)
          : launch_variant<true>(graw, gst, gsa, t, a, om, vpart, dt, da, part, J, B, Vt, Va,
                                 sum, stream);
  return (int)err;
}
