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
// floats) and writes dt and da (6) around 18 FMAs: at SMPL b4096 the four
// (3, V, B) arrays are 1.35 GB, 0.40 ms at 3.35 TB/s. The 15 cotangents of
// a (part, column) are the same for every vertex of the part.
//
// Design: a warp owns one tile of the part index (PartIndex in
// ops/lbs_kernels.py: each part's vertices cut into tiles of at most 32, one
// part per tile, as K13 and K14 walk them) and 128 columns, 4 a lane. It
// reads the tile's part's 15 cotangents once into registers (float4 where
// B % 4 == 0, VEC), then walks the tile's vertices (two at a time in the
// summed form, which reads only t): t and a in, dt and da out, each a float4
// row per lane, a 512-byte row per warp. Each block also
// zeroes its share of the rows in no part (PartIndex.unused). The summed form
// adds a lane's 4 columns in registers and the warp's lanes by shuffles in a
// fixed tree, and lane 0 writes the column block's partial (n_splits, 3, V_a);
// part_sums_bwd_sum_kernel adds the splits in order, then the part's gsa,
// then applies ω. No atomics: two runs give the same bits.
#include "template_tile.cuh"

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;   // tiles per block
constexpr int CB = 128;          // batch columns per warp: 4 a lane

// The static fit weight of vertex v (the column (V_pad, 1)), zero past the
// targets' rows.
__device__ inline float static_weight(const float* __restrict__ om, int v, int Vt) {
  return v < Vt ? __ldg(om + v) : 0.f;
}

template <bool VEC, bool W, bool SUM>
__global__ void __launch_bounds__(NT, 2)
part_sums_bwd_kernel(const float* __restrict__ graw, const float* __restrict__ gst,
                     const float* __restrict__ gsa, const float* __restrict__ t,
                     const float* __restrict__ a, const float* __restrict__ om,
                     const int* __restrict__ verts, const int* __restrict__ tile_offset,
                     const int* __restrict__ vpart, const int* __restrict__ unused,
                     float* __restrict__ dt, float* __restrict__ da, float* __restrict__ part,
                     int J, int B, int Vt, int Va, int n_tiles, int n_unused) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bc = blockIdx.x * CB + 4 * lane;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  // This block's share of the rows in no part: their dt (and da) rows zero.
  const int u0 = (int)((long)n_unused * blockIdx.y / gridDim.y);
  const int u1 = (int)((long)n_unused * (blockIdx.y + 1) / gridDim.y);
  for (int u = u0 + warp; u < u1; u += WARPS) {
    const int v = __ldg(unused + u);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (v < Vt) tmpl::store4<VEC>(dt + ((size_t)c * Vt + v) * B + bc, zero, bc, B);
      if (!SUM && v < Va) tmpl::store4<VEC>(da + ((size_t)c * Va + v) * B + bc, zero, bc, B);
    }
  }

  const int tile = blockIdx.y * WARPS + warp;
  if (tile >= n_tiles) return;  // uniform across the warp
  const int beg = __ldg(tile_offset + tile), end = __ldg(tile_offset + tile + 1);
  const int p = __ldg(vpart + __ldg(verts + beg));
  float w9[9][4], st[3][4], sa[3][4];
#pragma unroll
  for (int x = 0; x < 9; ++x)
    tmpl::load4<VEC>(w9[x], graw + ((size_t)x * J + p) * B + bc, bc, B);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tmpl::load4<VEC>(st[c], gst + ((size_t)c * J + p) * B + bc, bc, B);
    if (!SUM) tmpl::load4<VEC>(sa[c], gsa + ((size_t)c * J + p) * B + bc, bc, B);
  }
  const int n_rows = Vt > Va ? Vt : Va;
  // Vertices in flight per step: the summed form reads only t, so two fit in
  // its registers without spilling.
  constexpr int NV = SUM ? 2 : 1;
  for (int r0 = beg; r0 < end; r0 += NV) {
    int vs[NV];
    float tc[NV][3][4], ad[NV][3][4];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = r0 + n < end ? __ldg(verts + r0 + n) : n_rows;
      vs[n] = v;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (v < Vt) {
          tmpl::load4<VEC>(tc[n][c], t + ((size_t)c * Vt + v) * B + bc, bc, B);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) tc[n][c][k] = 0.f;
        }
        if (SUM) {
          const float ac = v < Va ? __ldg(a + (size_t)c * Va + v) : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) ad[n][c][k] = ac;
        } else if (v < Va) {
          tmpl::load4<VEC>(ad[n][c], a + ((size_t)c * Va + v) * B + bc, bc, B);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) ad[n][c][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = vs[n];
      if (v >= n_rows) continue;  // uniform across the warp
      const float wv = W ? static_weight(om, v, Vt) : 1.f;
      // dt_c, each stored as soon as it is formed, then da_d.
      if (v < Vt) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float s = st[c][k];
#pragma unroll
            for (int d = 0; d < 3; ++d) s = fmaf(w9[c * 3 + d][k], ad[n][d][k], s);
            o[k] = s * wv;
          }
          tmpl::store4<VEC>(dt + ((size_t)c * Vt + v) * B + bc, o, bc, B);
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float s = SUM ? 0.f : sa[d][k];
#pragma unroll
          for (int c = 0; c < 3; ++c) s = fmaf(w9[c * 3 + d][k], tc[n][c][k], s);
          o[k] = s;
        }
        if (SUM) {
          float s = (o[0] + o[1]) + (o[2] + o[3]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
          if (lane == 0 && v < Va) part[((size_t)blockIdx.x * 3 + d) * Va + v] = s;
        } else if (v < Va) {
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] *= wv;
          tmpl::store4<VEC>(da + ((size_t)d * Va + v) * B + bc, o, bc, B);
        }
      }
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
#pragma unroll 8
      for (int sp = 0; sp < n_splits; ++sp) s += part[((size_t)sp * 3 + d) * Va + v];
      s = gsa[(size_t)d * J + p] + s;
    }
    da[idx] = s * (W ? static_weight(om, v, Vt) : 1.f);
  }
}

template <bool VEC, bool W>
cudaError_t launch_variant(const float* graw, const float* gst, const float* gsa,
                           const float* t, const float* a, const float* om, const int* verts,
                           const int* tile_offset, const int* vpart, const int* unused, float* dt,
                           float* da, float* part, int J, int B, int Vt, int Va, int n_tiles,
                           int n_unused, int sum, cudaStream_t stream) {
  const int n_splits = (B + CB - 1) / CB;
  const dim3 grid(n_splits, n_tiles > WARPS ? (n_tiles + WARPS - 1) / WARPS : 1);
  if (!sum) {
    part_sums_bwd_kernel<VEC, W, false><<<grid, NT, 0, stream>>>(
        graw, gst, gsa, t, a, om, verts, tile_offset, vpart, unused, dt, da, part, J, B, Vt, Va,
        n_tiles, n_unused);
    return cudaGetLastError();
  }
  part_sums_bwd_kernel<VEC, W, true><<<grid, NT, 0, stream>>>(
      graw, gst, gsa, t, a, om, verts, tile_offset, vpart, unused, dt, da, part, J, B, Vt, Va,
      n_tiles, n_unused);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  part_sums_bwd_sum_kernel<W><<<(3 * Va + threads - 1) / threads, threads, 0, stream>>>(
      part, gsa, om, vpart, da, J, Vt, Va, n_splits);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_weighted(const float* graw, const float* gst, const float* gsa,
                            const float* t, const float* a, const float* om, const int* verts,
                            const int* tile_offset, const int* vpart, const int* unused,
                            float* dt, float* da, float* part, int J, int B, int Vt, int Va,
                            int n_tiles, int n_unused, int sum, cudaStream_t stream) {
  return om == nullptr
             ? launch_variant<VEC, false>(graw, gst, gsa, t, a, om, verts, tile_offset, vpart,
                                          unused, dt, da, part, J, B, Vt, Va, n_tiles, n_unused,
                                          sum, stream)
             : launch_variant<VEC, true>(graw, gst, gsa, t, a, om, verts, tile_offset, vpart,
                                         unused, dt, da, part, J, B, Vt, Va, n_tiles, n_unused,
                                         sum, stream);
}

}  // namespace

// graw (9, J, B), gst (3, J, B), gsa (3, J, B) or with sum (3, J, 1), t (3, Vt,
// B), a (3, Va, B) or with sum (3, Va, 1), om null or the static fit weights
// (Vp, 1); the part index: verts (its vertices, part after part), tile_offset
// (n_tiles + 1) its 32-vertex tiles of one part each, vpart (Vp) each
// vertex's part or -1, unused (n_unused) the rows in no part (verts and
// unused hold every row below Vp once, Vp >= max(Vt, Va)) -> dt (3, Vt, B),
// da (3, Va, B) or with sum (3, Va, 1). part: with sum, scratch of
// ceil(B / 128) * 3 * Va floats (unused otherwise).
SMPL_API int part_sums_bwd_launch(const float* graw, const float* gst, const float* gsa,
                                  const float* t, const float* a, const float* om,
                                  const int* verts, const int* tile_offset, const int* vpart,
                                  const int* unused, float* dt, float* da, float* part, int J,
                                  int B, int Vt, int Va, int n_tiles, int n_unused, int sum,
                                  cudaStream_t stream) {
  const bool vec = B % 4 == 0 && sgemm::aligned16(graw) && sgemm::aligned16(gst) &&
                   sgemm::aligned16(gsa) && sgemm::aligned16(t) && sgemm::aligned16(a) &&
                   sgemm::aligned16(dt) && sgemm::aligned16(da);
  const cudaError_t err =
      vec ? launch_weighted<true>(graw, gst, gsa, t, a, om, verts, tile_offset, vpart, unused, dt,
                                  da, part, J, B, Vt, Va, n_tiles, n_unused, sum, stream)
          : launch_weighted<false>(graw, gst, gsa, t, a, om, verts, tile_offset, vpart, unused,
                                   dt, da, part, J, B, Vt, Va, n_tiles, n_unused, sum, stream);
  return (int)err;
}
